#!/usr/bin/env python3
"""Hold the nn1 kernel of this tree against another version of its source
on one card: bitwise outputs on chip_smoke.py's phase-3 cases, and the time
at the fitness shape, the two versions timed in turns (A, B, B, A).

    python3 scripts/compare_nn1_kernels.py OTHER_nn1.cu [--out FILE]

OTHER_nn1.cu is, for example, the parent commit's
delta_graph_slam_tpu_torch/csrc/nn1.cu unpacked with ``git archive`` into a
git-ignored directory. Both sources are built with ops/nn_kernel.py's
flags into the package's _build/ directory. A source whose ``dgs_nn1``
takes no batch argument (before the batch dimension) is called without it.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build(src: Path) -> Path:
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    text = src.read_bytes()
    digest = hashlib.sha256(text + " ".join(nn_kernel.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = nn_kernel.BUILD_DIR / f"libdgs_nn1_cmp_{digest}.so"
    if not out.exists():
        nn_kernel.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [nn_kernel._nvcc(), *nn_kernel.NVCC_FLAGS, "-o", str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return out


def launcher(src: Path):
    """fn(query, qmask, target, tmask, exclude_self) -> (d2, idx) through
    the library built from ``src``."""
    import torch

    from delta_graph_slam_tpu_torch.ops import nn_kernel

    batched = "int batch" in src.read_text()
    lib = ctypes.CDLL(str(build(src)))
    fn = lib.dgs_nn1
    n_int = 3 if batched else 2
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_int] * n_int + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int

    def run(q, qm, t, tm, exclude_self=False):
        n, m = q.shape[0], t.shape[0]
        d2 = torch.empty((n,), dtype=torch.float32, device=q.device)
        idx = torch.empty((n,), dtype=torch.int32, device=q.device)
        packed = torch.empty((max(m, 1), 4), dtype=torch.float32, device=q.device)
        splits, _ = nn_kernel.launch_geometry(n, m, nn_kernel.sm_count(q.device))
        ints = ([1] if batched else []) + [int(exclude_self), splits]
        err = fn(q.data_ptr(), qm.data_ptr(), n, t.data_ptr(), tm.data_ptr(), m,
                 *ints, packed.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{src}: cudaError {err}")
        return d2, idx

    return run


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", help="another nn1.cu")
    parser.add_argument("--out", help="write the measurements as JSON here")
    args = parser.parse_args()

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    this_src = ROOT / "delta_graph_slam_tpu_torch" / "csrc" / "nn1.cu"
    kernels = {"this": launcher(this_src), "other": launcher(Path(args.other))}
    cases = chip_smoke.nn_cases(np.random.default_rng(0))
    same = {}
    for name, q, qm, t, tm, excl in cases:
        a = [torch.from_numpy(x).cuda() for x in (q, qm, t, tm)]
        outs = [kernels[k](*a, exclude_self=excl) for k in ("this", "other")]
        same[name] = all(torch.equal(x, y) for x, y in zip(*outs))
    _, q, qm, t, tm, _ = cases[0]
    a = [torch.from_numpy(x).cuda() for x in (q, qm, t, tm)]
    times = []
    for k in ("other", "this", "this", "other"):
        times.append((k, chip_smoke.cuda_ms(lambda: kernels[k](*a), inner=10)))
    out = {"card": chip_smoke.smi("name,power.limit"), "bitwise": same,
           "fitness_ms_in_turns": times}
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    if not all(same.values()):
        sys.exit(f"outputs differ: {same}")


if __name__ == "__main__":
    main()
