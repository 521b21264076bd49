"""The record of the card and the host a run used: the last line's
``device`` and a detail line before it (what ``nvidia-smi`` reads, the
host's CPU model and core count), since host-paced cells move with the
host."""

from __future__ import annotations

import os
import subprocess
from typing import Dict

SMI_FIELDS = ("name", "power.limit", "clocks.sm", "clocks.max.sm",
              "clocks.mem", "temperature.gpu", "driver_version")


def cuda_ready(chips: int):
    """None when this process sees ``chips`` CUDA devices, else why not."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return "{} CUDA device(s) visible, the cell needs {}".format(
            torch.cuda.device_count(), chips)
    return None


def smi(index: int = 0) -> Dict[str, str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=" + ",".join(
                SMI_FIELDS), "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return {"error": str(exc)}
    if out.returncode != 0:
        return {"error": out.stderr.strip()[:200]}
    vals = [v.strip() for v in out.stdout.strip().split(",")]
    return dict(zip(SMI_FIELDS, vals))


def host_cpu() -> Dict:
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    try:
        usable = len(os.sched_getaffinity(0))
    except AttributeError:
        usable = os.cpu_count()
    return {"cpu_model": model, "cpu_count": os.cpu_count(),
            "cpus_usable": usable}


def detail(chips: int) -> Dict:
    import torch
    return {"cards": [smi(i) for i in range(chips)], "host": host_cpu(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def record(chips: int, peak_bytes: int) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}
