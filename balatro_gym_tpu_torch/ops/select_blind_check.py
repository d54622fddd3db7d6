"""The nvcc ``-O3`` fault once seen in ``select_blind``, rechecked on the card.

    python -m balatro_gym_tpu_torch.ops.select_blind_check     # on the card

``csrc/full_step.cuh``'s ``select_blind`` first wrote the blind type as
``clampi(a - 45, 0, 2)`` and the boss flag as ``bt == 2``; built for sm_90a,
that gave wrong blinds, so the header spells both out by comparisons. This
tool builds, into ``build/select_blind_check/`` and with nvcc itself:

* a minimal kernel holding the original two lines, with ptxas at -O3, -O1
  and -O0: its (blind type, boss) for actions 40-51, whether they are right,
  and the compares and selects of its SASS (``cuobjdump -sass``, the whole
  listing written beside the library);
* K3a and K2 from a copy of ``csrc/`` with the original lines put back, run
  on 8192 fresh games choosing the small, big and boss blind in turn, and
  held against the package's own K3a and K2 on the same batch.

It prints one JSON line; on a toolkit where the fault is gone, every count
of differing entries is 0 and the workaround may go.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess

import torch

from balatro_gym_tpu_torch.ops import cuda_build
from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops.alu_ceiling import card_name

REPRO_KERNEL = r"""
#include "full_step.cuh"
// select_blind's blind type and boss flag as first written.
__global__ void blind_repro_kernel(const int* a, int* bt, int* boss, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = clampi(a[i] - 45, 0, 2);
  bt[i] = t;
  boss[i] = t == 2;
}
extern "C" int blind_repro_launch(const int* a, int* bt, int* boss, int n) {
  blind_repro_kernel<<<(n + 127) / 128, 128>>>(a, bt, boss, n);
  return (int)cudaGetLastError();
}
"""
WORKAROUND = ("  const int bt = a <= 45 ? 0 : (a == 46 ? 1 : 2);", "  const bool is_boss = a >= 47;")
ORIGINAL = ("  const int bt = clampi(a - 45, 0, 2);", "  const bool is_boss = bt == 2;")
_P, _INT = ctypes.c_void_p, ctypes.c_int


def _nvcc(src, lib, extra=()):
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.ARCH_FLAGS,
                           *cuda_build.NVCC_FLAGS, *extra, "-o", str(lib), str(src)],
                          capture_output=True, text=True, cwd=src.parent)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def minimal_kernel(work, level, dev):
    """The minimal kernel built with ptxas at ``level`` (see the module
    docstring)."""
    lib = work / f"librepro_{level}.so"
    rep = _nvcc(work / "repro.cu", lib, ("-Xptxas", f"-{level}"))
    rep.blind_repro_launch.argtypes = [_P] * 3 + [_INT]
    rep.blind_repro_launch.restype = _INT
    a = torch.arange(40, 52, dtype=torch.int32, device=dev).repeat(1024)
    bt, boss = torch.empty_like(a), torch.empty_like(a)
    assert rep.blind_repro_launch(a.data_ptr(), bt.data_ptr(), boss.data_ptr(), a.numel()) == 0
    torch.cuda.synchronize()
    want_bt = (a - 45).clamp(0, 2)
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    (work / f"repro_{level}.sass").write_text(sass)
    body = sass[sass.index("blind_repro_kernel"):]
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+((?:@!?U?P\w+\s+)?[A-Z][A-Z0-9_.]*[^;]*);", body)
    return {"correct": bool(torch.equal(bt, want_bt) and torch.equal(boss, (want_bt == 2).int())),
            "bt_boss_by_action": {int(x): [int(y), int(z)] for x, y, z in
                                  zip(a[:12].tolist(), bt[:12].tolist(), boss[:12].tolist())},
            "sass_instructions": len(ops),
            "sass_compares": [o.strip() for o in ops
                              if re.match(r"(@\S+\s+)?V?(ISETP|SEL|IMNMX)", o)]}


def original_builds(work, dev, n=8192):
    """Entries in which K3a and K2 built with the original lines differ from
    the package's own builds, on fresh games choosing each blind in turn."""
    k3a = _nvcc(work / "fused_policy_rollout.cu", work / "libstep.so")
    k3a.policy_step_launch.argtypes = [_P] * 12 + [_INT, _P]
    k3a.policy_step_launch.restype = _INT
    k2 = _nvcc(work / "fused_full_rollout.cu", work / "libk2.so")
    k2.fused_full_rollout_launch.argtypes = FF._C_ARGS
    k2.fused_full_rollout_launch.restype = _INT
    packed = {k: v.contiguous() for k, v in
              FF.pack_full_state(FF.default_reset(2, n, dev)).items()}
    actions = (45 + torch.arange(n, device=dev) % 3).to(torch.int32)
    ft, stream = FF.float_tables(dev), torch.cuda.current_stream(dev).cuda_stream
    out = {k: torch.empty_like(v) for k, v in packed.items()}
    rest = (torch.empty(n, device=dev), torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(FP.OBS_DIM, n, device=dev),
            torch.empty(FP.N_ACTIONS, n, dtype=torch.bool, device=dev))
    assert k3a.policy_step_launch(
        packed["cards"].data_ptr(), packed["ints"].data_ptr(), packed["rng"].data_ptr(),
        actions.data_ptr(), ft.data_ptr(), out["cards"].data_ptr(), out["ints"].data_ptr(),
        out["rng"].data_ptr(), *(t.data_ptr() for t in rest), n, stream) == 0
    want = FP.step_fused(packed, actions, device=dev)
    want = (*want[0].values(), want[1], want[2], want[3].T, want[4].T)
    k2_out = {k: torch.empty_like(v) for k, v in packed.items()}
    tot, epi = torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev)
    assert k2.fused_full_rollout_launch(
        packed["cards"].data_ptr(), packed["ints"].data_ptr(), packed["rng"].data_ptr(),
        actions.data_ptr(), ft.data_ptr(), k2_out["cards"].data_ptr(),
        k2_out["ints"].data_ptr(), k2_out["rng"].data_ptr(), tot.data_ptr(), epi.data_ptr(),
        n, 1, 1, 0, 0, stream) == 0
    k2_want = FF._kernel_packed(packed, actions[None].contiguous(), 0, 1)
    torch.cuda.synchronize()
    return {"k3a": [int((x != y).sum()) for x, y in zip((*out.values(), *rest), want)],
            "k2": [int((k2_out[k] != k2_want[0][k]).sum()) for k in ("cards", "ints", "rng")]
            + [int((tot != k2_want[1]).sum()), int((epi != k2_want[2]).sum())]}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("select_blind_check: torch sees no CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    work = cuda_build.BUILD_DIR.parent / "select_blind_check"
    work.mkdir(parents=True, exist_ok=True)
    for f in ("full_step.cuh", "threefry.cuh", "fused_policy_rollout.cu", "fused_full_rollout.cu"):
        shutil.copy(cuda_build.CSRC / f, work / f)
    header = (work / "full_step.cuh").read_text()
    assert all(w in header for w in WORKAROUND), "select_blind's workaround moved"
    for w, o in zip(WORKAROUND, ORIGINAL):
        header = header.replace(w, o)
    (work / "full_step.cuh").write_text(header)
    (work / "repro.cu").write_text(REPRO_KERNEL)
    differ = original_builds(work, dev)
    out = {"minimal_kernel": {lv: minimal_kernel(work, lv, dev) for lv in ("O3", "O1", "O0")},
           "original_expression_entries_differing": differ,
           "original_expression_equal": not any(map(any, differ.values())),
           "nvcc": subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                                  text=True).stdout.strip().splitlines()[-1],
           "device": torch.cuda.get_device_name(0), "gpu": card_name()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":  # pragma: no cover
    main()
