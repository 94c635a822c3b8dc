"""Port parity: ray_tpu_torch's ring attention against the JAX package.

The loopback ring (every sp shard in this process) is held against JAX's
`ring_attention` under `shard_map` on the suite's virtual CPU devices (as
tests/test_ops_attention.py runs it), and against the port's own
full-sequence flash attention. On the CPU the ring's partials are the flash
kernels' plain versions. `ProcessGroupRing` runs on gloo processes
(tests/torch_dist_worker.py) and must equal the loopback.
"""

import functools
import importlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker
from ray_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from ray_tpu_torch.ops import attention as tattn

R = importlib.import_module("ray_tpu_torch.ops.ring_attention")

torch_dist_worker.settle()

# f32 on both sides, sums in another order: outputs (|out| < 3) and the
# gradients of sum(out**2) (|g| up to 26 at S 256) to 1e-5, relative and
# absolute (largest reading 7.9e-6 on |dK| 14.5)
F32_RTOL, F32_ATOL = 1e-5, 1e-5
# bf16: both sides round each partial's output to bf16 before the f32
# merge, and the final output to bf16; the output is held elementwise (read
# 7.3e-4, one bf16 ulp at |out| ~ 0.2), the f32 gradients normwise (read
# 4.8e-5 for dK)
BF16_OUT_ATOL = 2e-3
BF16_GRAD_RTOL = 1e-4


def _qkv(b=2, h=4, hk=2, s=256, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d))]


def _jax_ring(q, k, v, sp, causal, impl="reference", **kw):
    """JAX's ring under shard_map, set up as tests/test_ops_attention.py:80-88
    sets it up:
    the output and the q/k/v gradients of sum(out**2)."""
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    spec = P(None, None, "sp", None)
    ring = jax.shard_map(
        functools.partial(jax_ring_attention, axis_name="sp", causal=causal,
                          impl=impl, **kw),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)
    q, k, v = (jnp.asarray(x) for x in (q, k, v))
    out = jax.jit(ring)(q, k, v)
    grads = jax.jit(jax.grad(
        lambda q, k, v: (ring(q, k, v).astype(jnp.float32) ** 2).sum(),
        argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x, dtype=np.float32) for x in (out, *grads)]


def _loopback(q, k, v, sp, causal, dtype=torch.float32, impl="auto"):
    """The port's loopback ring over sp shards of the whole sequence: the
    output and the q/k/v gradients of sum(out**2), as numpy f32."""
    ts = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    shards = [list(t.chunk(sp, dim=2)) for t in ts]
    outs = R.ring_attention(*shards, R.LoopbackRing(sp), causal=causal,
                            impl=impl)
    out = torch.cat(outs, dim=2)
    (out.float() ** 2).sum().backward()
    return [x.detach().float().numpy() for x in (out, *(t.grad for t in ts))]


CASES = [pytest.param(sp, causal, id=f"sp{sp}-{'causal' if causal else 'full'}")
         for sp in (2, 4) for causal in (True, False)]


@pytest.mark.parametrize("sp, causal", CASES)
def test_loopback_matches_jax_ring(sp, causal):
    q, k, v = _qkv()
    want = _jax_ring(q, k, v, sp, causal)
    got = _loopback(q, k, v, sp, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("sp, causal", CASES)
def test_loopback_matches_full_flash(sp, causal):
    q, k, v = _qkv()
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tattn.flash_attention(*ts, causal)
    (out ** 2).sum().backward()
    want = [out.detach().numpy()] + [t.grad.numpy() for t in ts]
    got = _loopback(q, k, v, sp, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)


def test_reference_partials_match_loopback_kernels():
    """impl="reference" (the plain partials copied from JAX) and "auto"
    (the kernels' plain versions on the CPU) give the same ring."""
    q, k, v = _qkv(s=128)
    for causal in (True, False):
        a = _loopback(q, k, v, 4, causal, impl="reference")
        b = _loopback(q, k, v, 4, causal, impl="auto")
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=F32_RTOL, atol=F32_ATOL)


def test_loopback_bf16_matches_jax_ring():
    """bf16 inputs at sp 2 against JAX's ring on its Pallas partials (in
    interpret mode, block 128), which round each partial's output to bf16
    as the port's kernel partials do."""
    q, k, v = _qkv(b=1, h=4, hk=2, s=256)
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in (q, k, v))
    want = _jax_ring(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), 2,
                     True, impl="pallas_interpret", block_q=128, block_k=128)
    got = _loopback(q, k, v, 2, True, dtype=torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], atol=BF16_OUT_ATOL)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= BF16_GRAD_RTOL, (name, rel)


@pytest.mark.parametrize("sp, causal", CASES)
def test_partial_calls(sp, causal, monkeypatch):
    """The ring launches sp(sp+1)/2 partials causal (sp diagonal, the rest
    full) and sp² non-causal, forward and backward; a skipped step calls
    nothing."""
    calls = {"fwd": [], "bwd": []}

    def counting(kind, fn, causal_pos):
        def wrapped(*args, **kw):
            calls[kind].append(args[causal_pos])
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(R, "flash_fwd", counting("fwd", R.flash_fwd, 3))
    monkeypatch.setattr(R, "flash_bwd", counting("bwd", R.flash_bwd, 6))
    q, k, v = _qkv(b=1, s=64)
    _loopback(q, k, v, sp, causal)
    n = sp * (sp + 1) // 2 if causal else sp * sp
    for kind in ("fwd", "bwd"):
        assert len(calls[kind]) == n, (kind, calls[kind])
        assert sum(calls[kind]) == (sp if causal else 0)


def test_merge_of_two_empty_partials_stays_finite():
    """m and a partial's lse both NEG_INF: alpha = exp(0) = 1, as in JAX,
    and nothing turns into NaN."""
    q, k, v = (torch.tensor(x) for x in _qkv(b=1, s=16))

    def empty(q, k, v, scale, diag):
        return (torch.zeros_like(q),
                torch.full(q.shape[:3], tattn.NEG_INF))

    outs, lses = R._ring_fwd([q], [k], [v], R.LoopbackRing(1), False, 0.125,
                             empty)
    assert torch.equal(outs[0], torch.zeros_like(q))
    assert torch.isfinite(lses[0]).all() and (lses[0] < -1e29).all()


def test_ring_validates_arguments():
    q, k, v = (torch.tensor(x) for x in _qkv(b=1, s=32))
    shards = [list(t.chunk(2, dim=2)) for t in (q, k, v)]
    with pytest.raises(ValueError, match="cuda"):
        R.ring_attention(*shards, R.LoopbackRing(2), impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        R.ring_attention(*shards, R.LoopbackRing(2), impl="nope")
    with pytest.raises(ValueError, match="holds"):
        R.ring_attention(*shards, R.LoopbackRing(4))


@pytest.mark.parametrize("world", [2, 4])
def test_process_group_ring_equals_loopback(world, tmp_path):
    q, k, v = _qkv(s=128)
    inputs = tmp_path / "qkv.npz"
    np.savez(inputs, q=q, k=k, v=v)
    for causal in (True, False):
        t0 = time.monotonic()
        ranks = torch_dist_worker.launch(torch_dist_worker.ring_rank, world,
                                         tmp_path, str(inputs), causal)
        # where a failure happened: the xdist worker, and how close the
        # group came to launch's deadline
        where = (f"causal {causal}, xdist worker "
                 f"{os.environ.get('PYTEST_XDIST_WORKER', 'none')}, group "
                 f"took {time.monotonic() - t0:.1f} s of the "
                 f"{torch_dist_worker.LAUNCH_TIMEOUT:.0f} s deadline")
        for rank, res in enumerate(ranks):
            assert bool(res["cuda_raises"]), f"rank {rank}, {where}"
            for name in ("out", "dq", "dk", "dv"):
                # the same partials on the same values in the same order
                np.testing.assert_array_equal(
                    res[name], res[f"loopback_{name}"],
                    err_msg=f"{name} rank {rank}, {where}")
        # and the shards make up the loopback ring over the whole sequence,
        # bit for bit when both are computed in the ranks' processes ...
        full = ranks[0]["loopback_full_out"]
        for rank, res in enumerate(ranks):
            np.testing.assert_array_equal(res["loopback_full_out"], full,
                                          err_msg=f"rank {rank}, {where}")
        np.testing.assert_array_equal(
            np.concatenate([r["out"] for r in ranks], axis=2), full,
            err_msg=where)
        # ... and that ring is the one held against JAX above, computed in
        # this process (another process: sums may split another way)
        np.testing.assert_allclose(full, _loopback(q, k, v, world, causal)[0],
                                   rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=where)


def test_fresh_process_passes_are_bit_equal(tmp_path):
    """The premise of the test above, in fresh processes: two passes of the
    causal loopback ring at its shapes on 2 threads give the same bits.
    Without `settle` about 1 process in 10 to 40 (more under load) ran its
    first pass's `exp` on VML's low-accuracy kernel in one thread's rows,
    and its passes differed by up to 8.7e-5."""
    q, k, v = _qkv(s=128)
    inputs = tmp_path / "qkv.npz"
    np.savez(inputs, q=q, k=k, v=v)
    runs = torch_dist_worker.fresh_processes(
        torch_dist_worker.loopback_twice, 20, 5, tmp_path, str(inputs), 2,
        True)
    for i, res in enumerate(runs):
        for name in ("out", "dq", "dk", "dv"):
            np.testing.assert_array_equal(res[f"{name}1"], res[f"{name}2"],
                                          err_msg=f"{name}, process {i}")


def test_launch_after_a_group_left_its_store_behind(tmp_path):
    """The cause of the flake above: both of its groups ran in one
    directory, and where a rank of the first exited before its FileStore
    was destroyed, the second read the first's addresses from the file it
    left and hung on a dead port until the deadline ("Connection refused",
    240 s). A group that leaves its store file behind must not touch the
    next group in the same directory."""
    for leave, want in ((True, -1.0), (False, 3.0)):
        ranks = torch_dist_worker.launch(torch_dist_worker.store_left_behind,
                                         2, tmp_path, str(tmp_path), leave,
                                         timeout=60)
        assert [float(r["sum"][0]) for r in ranks] == [want, want]
        if leave:
            assert any(p.name.startswith("store_")
                       for p in tmp_path.iterdir())
