"""The rank actor of the collective parity test, in a module that imports
neither torch nor jax (a worker imports the module an actor class is
pickled from). One class serves both packages: it takes the package's name
(``ray_tpu`` or ``ray_tpu_torch``) and imports its collectives, so that the
same program runs through either runtime.

Inputs are made from seeded numpy on each rank; bf16 is made as its bit
pattern and becomes an ``ml_dtypes.bfloat16`` array for ``ray_tpu`` and a
torch ``bfloat16`` tensor for the port. Every result travels back as its
raw bytes, so the test compares bits (NaN payloads included).
"""

import importlib

import numpy as np

DTYPES = ("f32", "f64", "i32", "i64", "bf16")
OPS = ("sum", "prod", "min", "max")
WORLD = 4
SHAPE = (WORLD * 6, 1000)
# bf16 specials: +-inf, quiet and signalling NaNs of both signs, +-0, the
# largest finite values (their sum overflows), the smallest subnormals
BF16_SPECIALS = (0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81, 0xFFFF, 0x8000,
                 0x0000, 0x7F7F, 0xFF7F, 0x0001, 0x8001)


def bf16_bits(x32):
    """float32 -> bf16 bits, nearest-even (finite inputs)."""
    u = x32.view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def rank_input(kind, rank):
    """Rank `rank`'s seeded input of `kind` as numpy (bf16 as uint16
    bits). The first 2 x 12 bf16 elements are the specials, in an order
    that differs by rank, so that every rank pairs each special with
    others; the sums of the next 8 overflow to inf."""
    rng = np.random.default_rng(1000 * rank + DTYPES.index(kind))
    n = SHAPE[0] * SHAPE[1]
    if kind == "f32":
        out = (rng.standard_normal(n) * 4).astype(np.float32)
    elif kind == "f64":
        out = rng.standard_normal(n) * 4
    elif kind in ("i32", "i64"):
        out = rng.integers(-9, 10, n).astype(
            np.int32 if kind == "i32" else np.int64)
    else:
        out = bf16_bits((rng.standard_normal(n) * 4).astype(np.float32))
        k = len(BF16_SPECIALS)
        for i in range(2 * k):
            out[i] = BF16_SPECIALS[(i * (rank + 1) + rank) % k]
        # the largest finite value on every rank (its sum overflows to
        # inf), then +inf beside it on every other rank
        out[2 * k:2 * k + 4] = 0x7F7F
        out[2 * k + 4:2 * k + 8] = 0x7F80 if rank % 2 else 0x7F7F
    return out.reshape(SHAPE)


class ParityRank:
    """A collective rank of package `pkg`."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.col = importlib.import_module(f"{pkg}.comm.collective")

    def _rtpu_init_collective(self, world_size, rank, group_name):
        self.col.init_collective_group(world_size, rank, group_name)

    def configure(self, algo, wire, chunk_bytes):
        config = importlib.import_module(f"{self.pkg}._private.config")
        config.CONFIG._values.update({
            "collective_algo": algo, "collective_wire_dtype": wire,
            "collective_chunk_bytes": chunk_bytes})
        return True

    def _tensor(self, kind, arr):
        if self.pkg == "ray_tpu":
            if kind == "bf16":
                import ml_dtypes
                return arr.view(ml_dtypes.bfloat16)
            return arr
        import torch
        if kind == "bf16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)

    def _bits(self, kind, out):
        """`out`'s raw bytes and shape; for the port also checks that it
        is a tensor of the input's dtype."""
        if self.pkg == "ray_tpu":
            arr = np.ascontiguousarray(out)
        else:
            import torch
            want = {"f32": torch.float32, "f64": torch.float64,
                    "i32": torch.int32, "i64": torch.int64,
                    "bf16": torch.bfloat16}[kind]
            if not isinstance(out, torch.Tensor) or out.dtype != want:
                raise TypeError(f"{kind}: got {type(out)} "
                                f"{getattr(out, 'dtype', None)}")
            if kind == "bf16":
                out = out.view(torch.int16)
            arr = out.contiguous().numpy()
        return arr.shape, arr.view(np.uint8).tobytes()

    def run(self, broadcast_bf16=True):
        """Every op of the parity program on this rank's inputs:
        allreduce and reducescatter of each reduction, allgather, and a
        broadcast from rank 1 (bf16's only where `broadcast_bf16`)."""
        col = self.col
        rank = col.get_rank()
        out = {}
        for kind in DTYPES:
            x = self._tensor(kind, rank_input(kind, rank))
            for op in OPS:
                out["allreduce", kind, op] = self._bits(
                    kind, col.allreduce(x, op=op))
                out["reducescatter", kind, op] = self._bits(
                    kind, col.reducescatter(x, op=op))
            out["allgather", kind] = [self._bits(kind, p)
                                      for p in col.allgather(x)]
            if kind != "bf16" or broadcast_bf16:
                out["broadcast", kind] = self._bits(
                    kind, col.broadcast(x, src_rank=1))
        return out
