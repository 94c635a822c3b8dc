"""Lazy DAG authoring API (reference: ``python/ray/dag/``)."""

from .dag_node import (ClassMethodNode, ClassNode, DAGInputData, DAGNode,
                       FunctionNode, InputAttributeNode, InputNode,
                       MultiOutputNode)

__all__ = ["DAGNode", "DAGInputData", "FunctionNode", "ClassNode",
           "ClassMethodNode", "InputNode", "InputAttributeNode",
           "MultiOutputNode"]
