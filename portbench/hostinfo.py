"""What the run was on: the host's CPU, cores and load, and the card's
clocks, power draw and power limit (``nvidia-smi``)."""

from __future__ import annotations

import os
import platform
import shutil
import subprocess

QUERY = ("name,clocks.sm,clocks.mem,power.draw,power.limit,"
         "temperature.gpu,memory.used")


def cpu_model() -> str:
    """``lscpu``'s model name, else /proc/cpuinfo's, else (a sandbox may
    report "unknown") the vendor, family, model and clock."""
    lscpu = shutil.which("lscpu")
    if lscpu is not None:
        try:
            out = subprocess.run([lscpu], capture_output=True, text=True,
                                 timeout=10).stdout
        except (OSError, subprocess.TimeoutExpired):
            out = ""
        for line in out.splitlines():
            if line.strip().startswith("Model name"):
                name = line.split(":", 1)[1].strip()
                if name.lower() != "unknown":
                    return name
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor is enough
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    name = fields.get("model name", "unknown")
    if name != "unknown":
        return name
    # a sandbox may hide the name: give what identifies the part
    return (f"{fields.get('vendor_id', platform.machine() or '?')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')}"
            f" at {fields.get('cpu MHz', '?')} MHz")


def card_lines() -> list:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return ["nvidia-smi: not found"]
    try:
        out = subprocess.run(
            [smi, f"--query-gpu={QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e!r}"]
    rows = [r.strip() for r in out.stdout.splitlines() if r.strip()]
    return [f"card {i}: {r} ({QUERY})" for i, r in enumerate(rows)] or \
        [f"nvidia-smi: rc {out.returncode} {out.stderr.strip()[:200]}"]


def lines(card_only: bool = False) -> list:
    out = []
    if not card_only:
        load = os.getloadavg()
        out.append(f"cpu {cpu_model()}; {os.cpu_count()} logical cores; "
                   f"load average {load[0]:.2f} {load[1]:.2f} {load[2]:.2f}")
    return out + card_lines()
