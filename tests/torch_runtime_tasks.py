"""Task and actor bodies for the runtime tests of ``ray_tpu`` and
``ray_tpu_torch``, in a module that imports neither torch nor jax.

A worker imports the module that a function is pickled from, so a worker
that runs only these stays free of both (the hygiene test checks it). The
bodies that need a runtime take its module name and import it, so that one
program runs through either runtime.
"""

import importlib
import os
import sys
import time


def add(a, b):
    return a + b


def echo(x):
    return x


def three():
    return 1, 2, 3


def boom(msg):
    raise ValueError(msg)


def sleep_then(seconds, value):
    time.sleep(seconds)
    return value


def nested_child(x):
    return x * 2


def nested_parent(rt_name, x):
    # blocks in get() while holding a CPU; the node must release it so
    # the child can run (reference: NotifyDirectCallTaskBlocked)
    rt = importlib.import_module(rt_name)
    return rt.get(rt.remote(nested_child).remote(x)) + 1


def chain(rt_name, depth):
    rt = importlib.import_module(rt_name)
    if depth == 0:
        return 0
    return rt.get(rt.remote(chain).remote(rt_name, depth - 1)) + 1


class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def read(self):
        return self.value

    def pid(self):
        return os.getpid()


def heavy_modules():
    """Top-level packages of the heavy stacks this process has imported."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & {"torch", "jax", "jaxlib", "ray_tpu"})


def slots(rt_name):
    """This task's GPU slots and CUDA_VISIBLE_DEVICES."""
    rt = importlib.import_module(rt_name)
    return (rt.get_runtime_context().get_accelerator_ids(),
            os.environ.get("CUDA_VISIBLE_DEVICES"))


def slot_home(rt_name):
    """This task's GPU slots, CUDA_VISIBLE_DEVICES, node id (hex) and
    whether its worker has imported torch."""
    rt = importlib.import_module(rt_name)
    ctx = rt.get_runtime_context()
    return (ctx.get_accelerator_ids(),
            os.environ.get("CUDA_VISIBLE_DEVICES"),
            ctx.get_node_id().hex(), "torch" in sys.modules)


def cuda_probe():
    """Touch torch.cuda (which reads CUDA_VISIBLE_DEVICES once) and report
    what this worker sees."""
    import torch
    return (torch.cuda.is_available(),
            os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid())


class Slots:
    def ids(self, rt_name):
        return slots(rt_name)


def tensor_tree_double(tree):
    """Tensors in a nested dict, doubled; dtypes, shapes and
    requires_grad kept."""
    return {k: (tensor_tree_double(v) if isinstance(v, dict)
                else (v.detach() * 2).requires_grad_(v.requires_grad))
            for k, v in tree.items()}


def make_tensor(n):
    import torch
    return torch.arange(n, dtype=torch.float32).reshape(2, -1).t()


def zeros_u8(n):
    import numpy as np
    return np.zeros(n, dtype=np.uint8)


def nbytes_of(rt_name, refs):
    rt = importlib.import_module(rt_name)
    return rt.get(refs[0]).nbytes



class FixedSampler:
    """An env runner's `sample` that hands out one recorded batch: drives
    an algorithm's learning half on a batch sampled elsewhere."""

    def __init__(self, batch, stats):
        self.batch, self.stats = batch, stats

    def sample(self, weights, num_steps, compute_advantages=True):
        return self.batch, self.stats


def torch_threads():
    """torch's intra-op thread count in this worker."""
    import torch
    return torch.get_num_threads()


class TorchThreads:
    def get(self):
        return torch_threads()
