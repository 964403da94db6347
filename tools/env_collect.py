"""Environment diagnostics collector — the reference's
``tools/tf_env_collect.sh`` for this framework. Prints one JSON doc
with everything a bug report needs: versions, devices, mesh-relevant
env vars, host facts, repo state.

Usage: python tools/env_collect.py [--no-device]
(``--no-device`` skips touching the accelerator — useful when another
process holds a single-tenant device.)
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys


def _git(*args):
    try:
        return subprocess.run(["git", *args], capture_output=True,
                              text=True, timeout=10,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__)))
                              ).stdout.strip()
    except Exception:
        return None


def collect(touch_device: bool = True) -> dict:
    info: dict = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(("JAX_", "XLA_", "CUDA_", "NVIDIA_",
                                 "ENABLE_", "START_", "STOP_"))},
        "repo": {"commit": _git("rev-parse", "--short", "HEAD"),
                 "branch": _git("rev-parse", "--abbrev-ref", "HEAD"),
                 "dirty": bool(_git("status", "--porcelain"))},
    }
    for mod in ("jax", "jaxlib", "optax", "numpy"):
        try:
            info[mod] = __import__(mod).__version__
        except Exception as e:  # pragma: no cover - missing dep
            info[mod] = f"unavailable: {e}"
    try:
        with open("/proc/meminfo") as f:
            mem = dict(l.split(":", 1) for l in f.read().splitlines())
        info["host_mem_gb"] = round(
            int(mem["MemTotal"].split()[0]) / 2**20, 1)
    except Exception:
        pass
    if touch_device:
        try:
            import jax
            info["backend"] = jax.default_backend()
            info["devices"] = [str(d) for d in jax.devices()]
            info["process_count"] = jax.process_count()
        except Exception as e:
            info["devices"] = f"unavailable: {e}"
    return info


if __name__ == "__main__":
    print(json.dumps(collect("--no-device" not in sys.argv), indent=2,
                     sort_keys=True))
