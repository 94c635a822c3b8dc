"""`Cls.remote(...)` for the RL classes that JAX's package declares with
``@remote``: the class runs as an actor of the port's runtime, while
`Cls(...)` stays the in-process form that the tests and the card's smoke
drive without a runtime.
"""

from __future__ import annotations

from typing import Any, Dict


class RemoteMixin:
    _actor_options: Dict[str, Any] = {}

    @classmethod
    def options(cls, **options):
        """The class as an actor class with `options` over the class's
        defaults (JAX's ``@remote(...)`` arguments)."""
        from ..api import remote
        return remote(**{**cls._actor_options, **options})(cls)

    @classmethod
    def remote(cls, *args, **kwargs):
        return cls.options().remote(*args, **kwargs)
