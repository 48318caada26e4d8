"""Multi-host dryrun: two real OS processes under
jax.distributed.initialize on the CPU backend, exercising the global mesh,
a cross-process psum (the cross-host collective path), and the host-sharded FOV
fan-out. Real multi-host hardware is unavailable here; this is the
two-simulated-processes equivalent (SURVEY.md §4 fake-backend strategy)."""

import json
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["HIPRFISH_REPO"])
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

from hiprfish_tpu.parallel import distributed

ok = distributed.initialize_from_env()
assert ok, "initialize_from_env must detect the coordinator env"
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

assert jax.process_count() == 2
assert len(jax.devices()) == 4          # 2 procs x 2 local devices

mesh = distributed.global_mesh(fov=4, tile=1)
assert mesh.shape == {"fov": 4, "tile": 1}

# Cross-process psum over the global 'fov' axis (crosses processes).
def local_sum(x):
    return jax.lax.psum(x, "fov")

f = jax.jit(shard_map(local_sum, mesh=mesh,
                      in_specs=P("fov"), out_specs=P()))
import numpy as np
x = np.arange(4, dtype=np.float32) + 1.0     # 1+2+3+4 = 10 per element
xs = jax.device_put(x, NamedSharding(mesh, P("fov")))
total = f(xs)
# out_specs=P() -> fully replicated: read this process's local copy.
got = float(np.asarray(total.addressable_data(0)).reshape(-1)[0])
assert got == 10.0, got

# Host-sharded FOV fan-out: disjoint and covering.
samples = [f"fov_{i}" for i in range(7)]
mine = distributed.host_shard(samples)
print(json.dumps({"rank": jax.process_index(), "shard": mine,
                  "psum": got}))
"""


@pytest.mark.slow
def test_two_process_dcn_dryrun(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env_base = {
        **os.environ,
        "HIPRFISH_COORDINATOR": f"localhost:{port}",
        "HIPRFISH_NUM_PROCESSES": "2",
        "JAX_PLATFORMS": "cpu",
        "HIPRFISH_REPO": repo,
    }
    env_base.pop("XLA_FLAGS", None)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = []
    for rank in range(2):
        env = dict(env_base, HIPRFISH_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    shards = {o["rank"]: o["shard"] for o in outs}
    assert set(shards[0]) | set(shards[1]) == {f"fov_{i}" for i in range(7)}
    assert not set(shards[0]) & set(shards[1])
    assert all(o["psum"] == 10.0 for o in outs)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port
