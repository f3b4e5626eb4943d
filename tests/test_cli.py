import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")
SCENE = os.path.join(REPO, "scenes", "cornell", "cornell.obj")


def _run(args, timeout=400):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "monte_carlo_path_tracing_tpu.cli"] + args,
        capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout,
    )


@pytest.mark.slow
def test_cli_render_and_resume(tmp_path):
    out = str(tmp_path / "img.png")
    ckpt = str(tmp_path / "ck.npz")
    r = _run([
        "render", SCENE, "--width", "24", "--height", "24", "--spp", "4",
        "--estimator", "mis", "--max-depth", "3", "--out", out,
        "--checkpoint", ckpt, "--checkpoint-every", "2", "--cpu",
    ])
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["spp"] == 4 and stats["mean_radiance"] > 0
    assert os.path.exists(out) and os.path.exists(ckpt)

    # resume to 6 spp from the checkpoint
    r2 = _run([
        "render", SCENE, "--width", "24", "--height", "24", "--spp", "6",
        "--estimator", "mis", "--max-depth", "3",
        "--checkpoint", ckpt, "--checkpoint-every", "2", "--resume", "--cpu",
    ])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resuming" in r2.stdout


@pytest.mark.slow
def test_cli_regen_render(tmp_path):
    out = str(tmp_path / "img.npy")
    r = _run([
        "render", SCENE, "--width", "24", "--height", "24", "--spp", "4",
        "--estimator", "mis", "--max-depth", "8", "--regen",
        "--lanes", "512", "--out", out, "--cpu",
    ])
    assert r.returncode == 0, r.stderr[-2000:]
    img = np.load(out)
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
