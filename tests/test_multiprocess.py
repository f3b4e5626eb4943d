"""True multi-process distributed bring-up test.

Launches TWO Python processes, each owning 4 virtual CPU devices, joined
through jax.distributed (parallel/mesh.py::init_distributed_if_needed) into
one 8-device cluster — the standard JAX recipe for testing multi-host
semantics without a cluster (SURVEY.md §4). Each process runs the SAME program:
the distributed inverse-rendering train step (psum'd grads over a mesh that
spans both processes) and the sharded regeneration renderer. The reference
has no distributed counterpart (single OS thread, SURVEY.md §2); this is
the BASELINE.md "multi-host" axis.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys, dataclasses
import numpy as np

sys.path.insert(0, os.environ["MCPT_REPO"])

from monte_carlo_path_tracing_tpu.parallel.mesh import init_distributed_if_needed

init_distributed_if_needed()   # must precede any backend-touching jax call

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()
assert jax.local_device_count() == 4

from monte_carlo_path_tracing_tpu.parallel import make_mesh, make_train_step
from monte_carlo_path_tracing_tpu.parallel.sharded import make_regen_sharded
from monte_carlo_path_tracing_tpu.render.camera import generate_rays
from monte_carlo_path_tracing_tpu.scene import load_scene
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

sc = load_scene(os.path.join(os.environ["MCPT_REPO"], "scenes", "cornell", "cornell.obj"))
sc = dataclasses.replace(
    sc, camera=dataclasses.replace(sc.camera, width=16, height=16)
)
cfg = RenderConfig(spp=1, estimator="mis", max_depth=3, seed=0)
mesh = make_mesh((8,), ("tiles",))
rep = NamedSharding(mesh, P())
tiles = NamedSharding(mesh, P("tiles"))

# Replicated scene: every process holds identical values, so replication
# needs no communication.
sc = jax.device_put(sc, rep)

# Globally sharded rays: build the full arrays identically on every process
# and hand each device its slice via make_array_from_callback.
idx = jnp.arange(128, dtype=jnp.int32) % 256
ro_h, rd_h = generate_rays(sc.camera, idx)
ro_h, rd_h = np.asarray(ro_h), np.asarray(rd_h)
tgt_h = np.full((128, 3), 0.25, np.float32)
mk = lambda h: jax.make_array_from_callback(h.shape, tiles, lambda i: h[i])
ro, rd, target = mk(ro_h), mk(rd_h), mk(tgt_h)

step = make_train_step(sc, cfg, mesh, lr=0.1)
new_mats, loss = step(sc.materials, jax.random.key(0), ro, rd, target)
jax.block_until_ready((new_mats, loss))
assert np.isfinite(float(loss)), float(loss)
assert np.isfinite(np.asarray(new_mats.kd)).all()

# Sharded regeneration renderer across both processes.
regen = make_regen_sharded(sc, cfg, mesh, lanes_per_device=64)
fb, nrays = regen(sc, jax.random.key(0), jnp.int32(1))
jax.block_until_ready(fb)
assert int(nrays) > 0
for s in fb.addressable_shards:
    assert np.isfinite(np.asarray(s.data)).all()

print("MULTIPROC_OK", jax.process_index(), float(loss), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_cluster(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()

    procs = []
    for pid in (0, 1):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
            MCPT_REPO=_REPO,
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(worker)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )

    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
        assert "MULTIPROC_OK" in out, out[-4000:]
