#!/usr/bin/env python3
"""Does L2 residency of the hub rows pace kernel K1 (ell_expand)?

    python3 -m tpu_bfs_torch.tools.k1_l2_probe            # RMAT scale 21, 8192 lanes

The flagship's frontier table is in rank order (descending in-degree), so
its leading rows are the hub rows that the residual ELL gathers most. This
probe builds the flagship hybrid engine and times one level's residual pass
(every bucket, as chip_smoke.py's kernels phase does) on a random frontier
table, with and without an L2 access-policy window that marks the table's
leading bytes as persisting, in turns. It also prints what share of the
level's gather slots fall in the leading rows. Prints one JSON line per
measurement. Needs one CUDA device; the window is set through libcuda,
the CUDA low-level API, on a stream of its own.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time

import torch

# libcuda enums (cuda.h, CUDA 12)
CU_DEVICE_ATTRIBUTE_L2_CACHE_SIZE = 38
CU_DEVICE_ATTRIBUTE_MAX_PERSISTING_L2_CACHE_SIZE = 108
CU_DEVICE_ATTRIBUTE_MAX_ACCESS_POLICY_WINDOW_SIZE = 109
CU_LIMIT_PERSISTING_L2_CACHE_SIZE = 0x06
CU_STREAM_ATTRIBUTE_ACCESS_POLICY_WINDOW = 1
CU_ACCESS_PROPERTY_STREAMING = 1
CU_ACCESS_PROPERTY_PERSISTING = 2


class AccessPolicyWindow(ctypes.Structure):
    _fields_ = [("base_ptr", ctypes.c_void_p), ("num_bytes", ctypes.c_size_t),
                ("hitRatio", ctypes.c_float), ("hitProp", ctypes.c_int),
                ("missProp", ctypes.c_int)]


class StreamAttrValue(ctypes.Union):
    _fields_ = [("pad", ctypes.c_char * 64), ("accessPolicyWindow", AccessPolicyWindow)]


class LibCuda:
    """The few libcuda calls the window needs; every call is checked."""

    def __init__(self):
        self.lib = ctypes.CDLL("libcuda.so.1")

    def call(self, name, *args):
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} returned CUresult {rc}")

    def device_attr(self, attr: int, dev: int = 0) -> int:
        v = ctypes.c_int()
        self.call("cuDeviceGetAttribute", ctypes.byref(v), attr, dev)
        return v.value

    def persisting_limit(self, nbytes: int) -> int:
        self.call("cuCtxSetLimit", CU_LIMIT_PERSISTING_L2_CACHE_SIZE, ctypes.c_size_t(nbytes))
        got = ctypes.c_size_t()
        self.call("cuCtxGetLimit", ctypes.byref(got), CU_LIMIT_PERSISTING_L2_CACHE_SIZE)
        return got.value

    def window(self, stream: int, base: int, nbytes: int, hit_ratio: float) -> int:
        """Mark ``hit_ratio`` of [base, base + nbytes) persisting on ``stream``
        (0 bytes: no window) and drop lines persisted so far; returns the
        bytes read back."""
        v = StreamAttrValue()
        v.accessPolicyWindow = AccessPolicyWindow(base if nbytes else None, nbytes, hit_ratio,
                                                  CU_ACCESS_PROPERTY_PERSISTING,
                                                  CU_ACCESS_PROPERTY_STREAMING)
        s = ctypes.c_void_p(stream)
        self.call("cuStreamSetAttribute", s, CU_STREAM_ATTRIBUTE_ACCESS_POLICY_WINDOW,
                  ctypes.byref(v))
        self.call("cuCtxResetPersistingL2Cache")
        back = StreamAttrValue()
        self.call("cuStreamGetAttribute", s, CU_STREAM_ATTRIBUTE_ACCESS_POLICY_WINDOW,
                  ctypes.byref(back))
        return back.accessPolicyWindow.num_bytes


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flagship_graph(scale: int):
    """RMAT scale/ef16/seed1 (native stream), shared with chip_smoke.py's
    cache under build/."""
    from tpu_bfs_torch.tools.roofline import load_rmat

    return load_rmat(scale, 16)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--lanes", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_l2_probe: no CUDA device", file=sys.stderr)
        return 2
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.ops import ell_expand as k1

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    t0 = time.perf_counter()
    g = flagship_graph(args.scale)
    eng = HybridMsBfsEngine(g, max_lanes=args.lanes, device=dev)
    arrs, hg, w = eng.arrs, eng.hg, eng.w
    names = (["virtual"] if hg.res_heavy else []) + [f"light{i}" for i in range(len(hg.res_light))]
    fw = torch.randint(-(2**31), 2**31 - 1, (hg.vt * 128, w), dtype=torch.int32, device=dev)
    row_bytes = w * 4

    drv = LibCuda()
    l2 = drv.device_attr(CU_DEVICE_ATTRIBUTE_L2_CACHE_SIZE)
    persist_max = drv.device_attr(CU_DEVICE_ATTRIBUTE_MAX_PERSISTING_L2_CACHE_SIZE)
    window_max = drv.device_attr(CU_DEVICE_ATTRIBUTE_MAX_ACCESS_POLICY_WINDOW_SIZE)
    limit = drv.persisting_limit(persist_max)

    # Share of the level's gather slots (pad slots included) in the leading rows.
    slots = torch.cat([arrs[f"{n}_gt"].reshape(-1) for n in names])
    share = {}
    for mb in (8, 16, 32, 48, 64, 128):
        rows = mb * 2**20 // row_bytes
        share[mb] = float((slots < rows).float().mean())
    pad = float((slots == hg.vt * 128 - 1).float().mean())
    emit({"phase": "setup", "nvidia_smi": smi, "setup_s": time.perf_counter() - t0,
          "l2_bytes": l2, "max_persisting_bytes": persist_max, "max_window_bytes": window_max,
          "persisting_limit_set": limit, "row_bytes": row_bytes, "gather_slots": slots.numel(),
          "pad_slot_share": pad, "slot_share_in_leading_mb": share})
    del slots

    stream = torch.cuda.Stream(dev)
    windows = [0, limit // 2, limit, min(2 * limit, window_max)]

    def ratio(wb):  # a window larger than the set-aside persists a sample of it
        return 1.0 if wb <= limit else limit / wb

    def level():  # one level's residual pass: every bucket
        return [k1.ell_expand(arrs[f"{n}_need"], arrs[f"{n}_gt"], fw) for n in names]

    times = {wb: [] for wb in windows}
    with torch.cuda.stream(stream):
        drv.window(stream.cuda_stream, 0, 0, 1.0)
        want = level()
        for wb in windows + windows[::-1]:
            back = drv.window(stream.cuda_stream, fw.data_ptr(), wb, ratio(wb))
            if back != wb:
                raise RuntimeError(f"window of {wb} bytes read back as {back}")
            got = level()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"window {wb}: output differs")
            del got
            times[wb].append(cuda_ms(level, args.reps))
        drv.window(stream.cuda_stream, 0, 0, 1.0)
    for wb, t in times.items():
        emit({"phase": "k1_level", "window_bytes": wb, "hit_ratio": ratio(wb),
              "window_rows": wb // row_bytes, "ms": t, "mean_ms": sum(t) / len(t)})
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
