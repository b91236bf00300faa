"""The stack sampler of the port's scripts (tpu_bfs_torch/tools/stack_sample.py):
a script that spins in one function for a known time, sampled in a process
of its own, names that function in every table of the summary."""

import json
import subprocess
import sys
from pathlib import Path

from tpu_bfs_torch.tools import stack_sample

from torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys, time
from tpu_bfs_torch.tools import stack_sample

stack_sample.start(sys.argv[1], interval=0.01)


def spin(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def main():
    spin(0.8)


main()
"""


def test_a_spinning_function_fills_the_samples(tmp_path, capsys):
    script, out = tmp_path / "busy.py", tmp_path / "samples.json"
    script.write_text(SCRIPT)
    proc = subprocess.run([sys.executable, str(script), str(out)], capture_output=True,
                          text=True, timeout=120, env=subprocess_env(PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    assert doc["script"] == "busy.py" and doc["interval"] == 0.01
    assert doc["samples"] >= 20  # 0.8 s at 10 ms, whatever the host's load
    spun = sum(n for path, n in doc["paths"] if path.startswith("<module>:18>main:15>spin:"))
    assert spun >= 0.8 * doc["samples"]
    summ = stack_sample.summarize(doc, depth=3, top=5)
    assert summ["sampled_s"] == round(doc["samples"] * 0.01, 2)
    path, secs = summ["by_path"][0]
    assert path.startswith("<module>:18>main:15>spin:") and secs >= 0.16
    assert summ["by_path_and_package_frame"][0][0] == path + " | -"
    assert summ["package_functions"] == []  # the spin is the script's own
    assert stack_sample.main([str(out), "--depth", "2", "--top", "1"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["by_path"][0][0] == "<module>:18>main:15"
