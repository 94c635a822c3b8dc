"""The slice's shape on the CPU: a job submitted to a process-isolated
cluster of ray_tpu_torch trains llama_tiny in a task, through the plain
attention, from weights JAX made (carried across by
``models/convert.py``). Its losses are the same steps' taken in this
process, bit for bit, and JAX's within the trajectory tolerance of
tests/test_torch_training.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtrain
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.job import JobStatus, JobSubmissionClient
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import params_from_jax

STEPS = 2
OPT_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)
# tests/test_torch_training.py's per-step bound against JAX
TRAJ_RTOL = 2e-4
RESULT = "JOB_RESULT "

DRIVER = """
import json, os, sys
import ray_tpu_torch as rt
import torch_dist_worker
rt.init(address=os.environ["RTPU_ADDRESS"])
out = rt.get(rt.remote(torch_dist_worker.job_train_steps).options(
    num_cpus=1).remote({params!r}, {tokens!r}, {steps}, {opt!r}),
    timeout=300)
out["driver_pid"] = os.getpid()
print({prefix!r} + json.dumps(out), flush=True)
rt.shutdown()
"""


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """llama_tiny's seed-0 parameters as JAX makes them, in the port's
    names, the tokens, and JAX's losses over the same steps."""
    tmp = tmp_path_factory.mktemp("job_train")
    jc = jgpt.llama_tiny(dtype=jnp.float32, attention_impl="reference")
    tc = tgpt.llama_tiny()
    jm = jgpt.GPT(jc)
    jopt = jtrain.make_optimizer(**OPT_KW)
    jstate = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0))
    state = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params), tc)
    params = tmp / "params.npz"
    np.savez(params, **{n: t.numpy() for n, t in state.items()})
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 64),
                                             dtype=np.int32)
    tokens = tmp / "tokens.npz"
    np.savez(tokens, tokens=toks)
    jstep = jtrain.make_train_step(jm, jopt, donate=False)
    jlosses = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(toks)})
        jlosses.append(float(m["loss"]))
    return tmp, str(params), str(tokens), jlosses


def test_submitted_job_trains_as_in_process(weights):
    tmp, params, tokens, jlosses = weights
    tests = os.path.dirname(os.path.abspath(__file__))
    pp = os.environ.get("PYTHONPATH", "")
    # the task's module is imported by name on the node and in the job
    env = {"PYTHONPATH": tests + (os.pathsep + pp if pp else "")}
    cluster = Cluster(process_isolated=True,
                      head_node_args={"num_cpus": 2, "env": env})
    try:
        client = JobSubmissionClient(f"127.0.0.1:{cluster.head.job_port}")
        script = tmp / "driver.py"
        script.write_text(DRIVER.format(params=params, tokens=tokens,
                                        steps=STEPS, opt=OPT_KW,
                                        prefix=RESULT))
        job_id = client.submit_job(entrypoint=f"python {script}")
        rec = client.wait_until_finished(job_id, timeout=240)
        logs = client.get_job_logs(job_id)
        assert rec["status"] == JobStatus.SUCCEEDED, logs
        line = next(ln for ln in logs.splitlines() if ln.startswith(RESULT))
        job = json.loads(line[len(RESULT):])
    finally:
        cluster.shutdown()
    here = torch_dist_worker.job_train_steps(params, tokens, STEPS, OPT_KW)
    assert job["pid"] != here["pid"] != job["driver_pid"] != job["pid"]
    assert job["losses"] == here["losses"]
    assert job["grad_norms"] == here["grad_norms"]
    np.testing.assert_allclose(job["losses"], jlosses, rtol=TRAJ_RTOL)
