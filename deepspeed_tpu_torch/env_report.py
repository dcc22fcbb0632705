"""``ds_report_torch`` — environment / op-compatibility report (reference:
deepspeed/env_report.py + bin/ds_report; the port of
``deepspeed_tpu/env_report.py``): versions, the CUDA toolkit, the cards,
and the build status of the host ops and of every CUDA kernel library."""
from __future__ import annotations

import os
import subprocess
import sys

#: seconds the device probe may take (env override:
#: DS_REPORT_DEVICE_TIMEOUT)
DEVICE_TIMEOUT_S = 45

_DEVICE_PROBE = ("import torch; n = torch.cuda.device_count(); "
                 "print(n, torch.cuda.get_device_name(0) if n else '-', "
                 "sep='|')")


def _run(cmd, timeout_s: float):
    """(returncode, stdout, stderr) of ``cmd``; (None, "", why) when it
    cannot start or outlives ``timeout_s``."""
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None, "", f"no response in {timeout_s}s"
    except OSError as e:
        return None, "", str(e)
    return r.returncode, r.stdout.strip(), r.stderr.strip()


def _device_line(deadline_s: int = DEVICE_TIMEOUT_S) -> tuple:
    """The cards, with a hard deadline: CUDA's initialization can block
    on a wedged driver, and a report tool that hangs is worse than
    useless when diagnosing exactly that.  The probe runs in a
    subprocess, so the report never initializes CUDA itself; nvidia-smi
    adds each card's name and power limit."""
    try:
        deadline_s = int(os.environ.get("DS_REPORT_DEVICE_TIMEOUT",
                                        str(deadline_s)))
    except ValueError:
        # the diagnostic tool must not die on a malformed knob — that is
        # the exact robustness this function exists for
        pass
    rc, out, err = _run([sys.executable, "-c", _DEVICE_PROBE], deadline_s)
    if rc is None:
        return ("devices", f"UNREACHABLE ({err} — driver down or wedged)")
    if rc != 0:
        tail = err.splitlines()
        return ("devices",
                f"unavailable ({tail[-1] if tail else 'init failed'})")
    try:
        n, name = out.splitlines()[-1].split("|")
    except ValueError:
        return ("devices", f"unparseable probe output {out!r}")
    if n == "0":
        return ("devices", "none (torch.cuda.device_count() is 0)")
    line = f"{n} × {name} (torch.cuda)"
    rc, smi, _ = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], deadline_s)
    if rc == 0 and smi:
        line += "; nvidia-smi: " + " / ".join(smi.splitlines())
    return ("devices", line)


def _nvcc_line() -> tuple:
    from .ops.kernels.build import nvcc
    try:
        path = nvcc()
    except RuntimeError:
        return ("nvcc", "NOT FOUND (the CUDA kernels cannot be built)")
    rc, out, _ = _run([path, "--version"], 30)
    release = out.splitlines()[-2] if rc == 0 and out else "?"
    return ("nvcc", f"{path}: {release}")


def collect_report() -> list:
    lines = [("python", sys.version.split()[0])]
    try:
        import torch
        lines.append(("torch", f"{torch.__version__} (CUDA "
                      f"{torch.version.cuda or 'none: a CPU build'})"))
    except ImportError:
        lines.append(("torch", "NOT INSTALLED"))
    try:
        import numpy
        lines.append(("numpy", numpy.__version__))
    except ImportError:
        lines.append(("numpy", "NOT INSTALLED"))
    lines.append(_nvcc_line())
    lines.append(("CUDA_HOME", os.environ.get("CUDA_HOME", "(unset)")))
    lines.append(_device_line())
    from .ops.op_builder import cpu_ops_status
    lines.append(("native host ops", cpu_ops_status()))
    # per-library matrix (the reference ds_report's main table): nothing
    # is compiled here, the report reads what the kernel build left
    from .git_version_info import compatible_ops
    for op, st in sorted(compatible_ops.items()):
        lines.append((f"kernel {op}", "built" if st["built"] else (
            "not built (built on first use)" if st["buildable"]
            else "UNAVAILABLE (no nvcc)")))
    from . import __version__
    from .git_version_info import git_branch, git_hash
    lines.append(("deepspeed_tpu_torch", f"{__version__} "
                  f"(git {git_hash}, {git_branch})"))
    return lines


def main():
    print("-" * 60)
    print("deepspeed_tpu_torch environment report")
    print("-" * 60)
    for key, val in collect_report():
        print(f"{key:.<30} {val}")
    print("-" * 60)


if __name__ == "__main__":
    main()
