"""Lazy task/actor DAGs: ``.bind()`` builds the graph, ``.execute()``
submits it.

Reference analogue: ``python/ray/dag/dag_node.py:23`` (DAGNode),
``function_node.py`` / ``class_node.py`` / ``input_node.py`` /
``output_node.py``. Same authoring surface — ``fn.bind(...)``,
``Actor.bind(...)``, ``node.method.bind(...)``, ``InputNode``,
``MultiOutputNode`` — with one execution semantic: every bound task is
submitted with its upstream results passed as ``ObjectRef``s, so the
scheduler pipelines the whole graph without materializing intermediates
on the driver (the data plane stays in the object store / device mesh).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

_MISSING = object()


class DAGNode:
    """Base: a lazily-bound computation with DAG-node arguments."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal -----------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def execute(self, *input_args, **input_kwargs) -> Any:
        """Submit the whole graph; returns the ObjectRef(s) of this node
        (a list for MultiOutputNode). Diamond dependencies submit once."""
        ctx = _ExecutionContext(input_args, input_kwargs)
        return self._resolve(ctx)

    def _resolve(self, ctx: "_ExecutionContext") -> Any:
        memo = ctx.memo
        if id(self) in memo:
            return memo[id(self)]
        result = self._execute_impl(ctx)
        memo[id(self)] = result
        return result

    def _resolve_args(self, ctx) -> Tuple[list, dict]:
        args = [a._resolve(ctx) if isinstance(a, DAGNode) else a
                for a in self._bound_args]
        kwargs = {k: (v._resolve(ctx) if isinstance(v, DAGNode) else v)
                  for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_impl(self, ctx) -> Any:
        raise NotImplementedError

    # -- introspection (used by workflow's planner) --------------------
    def walk(self):
        """Yield every node in the graph (post-order, deduped)."""
        seen = set()

        def rec(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for c in node._children():
                yield from rec(c)
            yield node

        yield from rec(self)


class _ExecutionContext:
    def __init__(self, input_args: tuple, input_kwargs: dict):
        self.input_args = input_args
        self.input_kwargs = input_kwargs
        self.memo: Dict[int, Any] = {}


class FunctionNode(DAGNode):
    """``remote_fn.bind(*args)`` — executes as one task submission."""

    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, ctx):
        args, kwargs = self._resolve_args(ctx)
        return self._remote_fn.remote(*args, **kwargs)

    def __repr__(self):
        return f"FunctionNode({self._remote_fn._name})"


class DAGInputData:
    """The full ``execute(*args, **kwargs)`` payload when more than one
    value was passed (reference: ``dag/input_node.py`` DAGInputData).
    ``[int]`` selects positionals, ``[str]``/attribute selects kwargs."""

    def __init__(self, args: tuple, kwargs: dict):
        self.args = args
        self.kwargs = kwargs

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.args[key]
        return self.kwargs[key]

    def __getattr__(self, name):
        try:
            return self.__dict__["kwargs"][name]
        except KeyError:
            raise AttributeError(name) from None


class InputNode(DAGNode):
    """Placeholder for ``execute()``'s arguments.

    ``with InputNode() as inp:`` matches the reference's authoring
    idiom. With a single positional argument ``inp`` IS that value;
    otherwise it is a :class:`DAGInputData` and ``inp[i]`` /
    ``inp.field`` select into positionals / keywords.
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_impl(self, ctx):
        if not ctx.input_args and not ctx.input_kwargs:
            raise ValueError("DAG contains an InputNode but execute() "
                             "was called with no arguments")
        if len(ctx.input_args) == 1 and not ctx.input_kwargs:
            return ctx.input_args[0]
        return DAGInputData(ctx.input_args, ctx.input_kwargs)

    def __getitem__(self, key):
        return InputAttributeNode(self, key, kind="item")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name, kind="attr")


class InputAttributeNode(DAGNode):
    """``inp[key]`` / ``inp.attr`` — selects into the execute() input."""

    def __init__(self, parent: DAGNode, key, kind: str):
        super().__init__((parent,), {})
        self._key = key
        self._kind = kind

    def _execute_impl(self, ctx):
        base = self._bound_args[0]._resolve(ctx)
        if self._kind == "item":
            return base[self._key]
        return getattr(base, self._key)


class ClassNode(DAGNode):
    """``ActorClass.bind(*ctor_args)`` — instantiated at execute()."""

    def __init__(self, actor_cls, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls

    def _execute_impl(self, ctx):
        args, kwargs = self._resolve_args(ctx)
        return self._actor_cls.remote(*args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodProxy(self, name)


class _ClassMethodProxy:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name,
                               args, kwargs)


class ClassMethodNode(DAGNode):
    """``class_node.method.bind(*args)`` — an actor call in the graph.

    The owning actor is created once per ``execute()`` (memoized via the
    ClassNode), so chained method nodes hit the same instance.
    """

    def __init__(self, class_node: ClassNode, method_name: str,
                 args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _children(self):
        return [self._class_node] + super()._children()

    def _execute_impl(self, ctx):
        handle = self._class_node._resolve(ctx)
        args, kwargs = self._resolve_args(ctx)
        return getattr(handle, self._method_name).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundle several terminal nodes; ``execute()`` returns their refs
    as a list (reference: ``output_node.py``)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_impl(self, ctx):
        return [a._resolve(ctx) if isinstance(a, DAGNode) else a
                for a in self._bound_args]
