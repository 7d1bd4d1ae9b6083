"""Which device a measurement ran on.

Every record that bench.py, chip_smoke.py and benchmarks/* print names the
JAX platform, device kind and device count, and the card's name and power
limit as nvidia-smi reports them (a card set below its maximum power runs
slower under load, so a time means little without it). A measurement path
that finds no GPU fails; it does not fall back to the CPU.
"""

import subprocess

NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader")


def nvidia_smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    output (one line per card), or "unavailable: <reason>"."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable: {type(e).__name__}: {e}"
    if out.returncode != 0:
        return f"unavailable: nvidia-smi exited {out.returncode}"
    return out.stdout.strip()


def device_record() -> dict:
    """{"platform", "kind", "count"} of jax.devices(), as JAX reports
    them."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


class NoGPUError(RuntimeError):
    """Raised by require_gpu when JAX's default platform is not a GPU."""


def require_gpu() -> dict:
    """device_record(), or NoGPUError when the devices are not GPUs."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise NoGPUError(
            f"JAX found no GPU (platform {rec['platform']!r}, kind "
            f"{rec['kind']!r}); this measurement runs only on the card")
    return rec
