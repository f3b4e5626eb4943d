"""The measurement device: entry points that time or check the GPU refuse
to run anywhere else, and name the card they ran on."""

from __future__ import annotations

import subprocess

import jax


def require_gpu():
    """The first JAX device, which must be a GPU. Raises SystemExit (a
    non-zero exit) otherwise: a measurement path has no CPU fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX found {dev.platform!r} ({dev.device_kind})"
        )
    return dev


def nvidia_smi() -> str:
    """The cards' name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
