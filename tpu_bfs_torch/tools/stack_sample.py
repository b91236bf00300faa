#!/usr/bin/env python3
"""Where a long script's host time goes: its main thread's stack, sampled.

    python3 chip_smoke.py --stack-sample samples.json
    python3 -m tpu_bfs_torch.tools.stack_sample samples.json

:func:`start` runs a daemon thread that reads the calling (main) thread's
stack every ``interval`` seconds (``sys._current_frames``) and, at exit,
writes the counts as JSON: each frame's inclusive samples, each call path
through the script's own file, and each path with its innermost frame of
``tpu_bfs_torch`` and its innermost frame of all. A sample is taken only
when the sampler thread gets the GIL, so a long C call that holds it
(some NumPy sorts, SciPy's csgraph) shows as fewer samples than its time:
``samples x interval`` falls short of the run's seconds by that much.

The command line prints a samples file's totals: seconds by call path
(``--depth`` frames of the script's file), by path and library frame, and
each ``tpu_bfs_torch`` function's inclusive seconds.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import json
import os
import re
import sys
import threading

# A path's frames ("name:line") joined by ">": a separator follows a line
# number, never the ">" of a name such as "<module>".
_FRAMES = re.compile(r"(?<=\d)>")


def _short(filename: str) -> str:
    for key in ("tpu_bfs_torch/", "site-packages/", "python3."):
        i = filename.find(key)
        if i >= 0:
            return filename[i:]
    return os.path.basename(filename)


def start(out_path: str, *, interval: float = 0.05, script: str | None = None) -> None:
    """Sample the calling thread's stack until the interpreter exits, then
    write the counts to ``out_path``. ``script`` (the basename of the file
    whose frames make the call paths) defaults to ``sys.argv[0]``'s."""
    target = threading.get_ident()
    script = script or os.path.basename(sys.argv[0])
    incl = collections.Counter()  # (file, function, line) -> samples
    paths = collections.Counter()  # the script's frames -> samples
    leaves = collections.Counter()  # path | package frame | innermost frame
    taken = [0]
    stop = threading.Event()

    def run() -> None:
        while not stop.wait(interval):
            frame = sys._current_frames().get(target)
            stack = []
            while frame is not None:
                stack.append((_short(frame.f_code.co_filename), frame.f_code.co_name,
                              frame.f_lineno))
                frame = frame.f_back
            if not stack:
                continue
            stack.reverse()
            taken[0] += 1
            for fr in set(stack):
                incl[fr] += 1
            path = ">".join(f"{fn}:{ln}" for fl, fn, ln in stack if fl == script)
            paths[path] += 1
            pkg = [fr for fr in stack if fr[0].startswith("tpu_bfs_torch/")]
            inner = ":".join(map(str, pkg[-1])) if pkg else "-"
            leaves[f"{path} | {inner} | {':'.join(map(str, stack[-1]))}"] += 1

    def dump() -> None:
        stop.set()
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump({"interval": interval, "samples": taken[0], "script": script,
                       "incl": [[*k, v] for k, v in incl.most_common()],
                       "paths": paths.most_common(), "leaf": leaves.most_common()}, fh)

    threading.Thread(target=run, name="stack-sample", daemon=True).start()
    atexit.register(dump)


def summarize(doc: dict, *, depth: int = 3, top: int = 40) -> dict:
    """Seconds (samples x interval) by call path cut to ``depth`` frames of
    the script, by path and package frame, and by ``tpu_bfs_torch``
    function (inclusive)."""
    iv = doc["interval"]
    by_path, by_leaf, by_fn = (collections.Counter() for _ in range(3))
    def cut(path):
        return ">".join(_FRAMES.split(path)[:depth])

    for path, n in doc["paths"]:
        by_path[cut(path)] += n
    for key, n in doc["leaf"]:
        path, pkg, _ = key.split(" | ")
        by_leaf[cut(path) + " | " + pkg] += n
    for fl, fn, _ln, n in doc["incl"]:
        if fl.startswith("tpu_bfs_torch/"):
            by_fn[f"{fl}:{fn}"] += n  # a frame is at one line a sample

    def secs(c):
        return [[k, round(n * iv, 2)] for k, n in c.most_common(top)]

    return {"sampled_s": round(doc["samples"] * iv, 2), "by_path": secs(by_path),
            "by_path_and_package_frame": secs(by_leaf), "package_functions": secs(by_fn)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("samples", help="a file written by start()")
    ap.add_argument("--depth", type=int, default=3, help="frames of the script a path keeps")
    ap.add_argument("--top", type=int, default=40, help="rows a table")
    args = ap.parse_args(argv)
    with open(args.samples) as fh:
        print(json.dumps(summarize(json.load(fh), depth=args.depth, top=args.top), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
