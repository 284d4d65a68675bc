"""Which device a measurement ran on.

Every number the benchmarks and ``chip_smoke.py`` print names its device:
JAX's platform, ``device_kind`` and device count, plus the card's name
and power limit as ``nvidia-smi`` reports them (a card set below its
maximum power runs slower under load, so a time means little without
it).  Measurement paths refuse to run on anything but a GPU: a CPU run
would print CPU numbers under a device metric's name.
"""

from __future__ import annotations

import subprocess

import jax

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card)."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()


def require_gpu() -> None:
    """Raise ``SystemExit`` unless JAX's first device is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found platform {platform!r}")


def device_record() -> dict:
    """Fields that name the device, for every printed record."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card_name_and_power_limit(),
    }
