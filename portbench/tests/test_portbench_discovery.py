"""A configuration, a mix, a driver and a metric added as new files (and
manifest entries) in a copy of the benchmark are found by name, with no
file of the harness edited."""

import json
import os
import subprocess
import sys

from tinycells import ROOT, tiny_root

DRIVER = '''
from portbench.harness import Record


def run(ctx):
    n = ctx.mix["requests"]
    return Record(run=ctx, setup_s=1.5, steps=[(0.0, 2.0)],
                  tokens_per_step=n, input_s=[0.001], model_flops_per_step=1.0,
                  dtype="float32", peak_bytes=None, trace=None, checks=[],
                  attempted=n, failed=0)
'''
METRIC = '''
def read(rec):
    return rec.attempted / rec.window_s
'''


def test_new_files_are_found(tmp_path):
    root = tiny_root(str(tmp_path))
    bench = os.path.join(root, "portbench")
    with open(os.path.join(bench, "configs", "other.json"), "w") as f:
        json.dump({"model_type": "none", "source": "x", "reduced": []}, f)
    with open(os.path.join(bench, "mixes", "toy-mix.json"), "w") as f:
        json.dump({"driver": "toy", "requests": 8}, f)
    with open(os.path.join(bench, "drivers", "toy.py"), "w") as f:
        f.write(DRIVER)
    with open(os.path.join(bench, "metrics", "toy_rate.py"), "w") as f:
        f.write(METRIC)
    with open(os.path.join(bench, "limits", "other-toy.json"), "w") as f:
        json.dump({}, f)
    path = os.path.join(root, "BENCHMARK.json")
    m = json.load(open(path))
    m["configs"].append({"name": "other", "source": "x",
                         "file": "portbench/configs/other.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "other-toy", "config": "other",
                           "traffic": "toy-mix", "chips": 1, "why": "t"})
    m["end_to_end"].append({"name": "toy_rate", "unit": "1/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["other-toy"]})
    json.dump(m, open(path, "w"))
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{root!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "from portbench import harness\n"
        f"b = harness.Bench({root!r})\n"
        "a = harness.parse(['--workload', 'other-toy', '--seed', '1', "
        "'--seconds', '1', '--trace', '0'])\n"
        "rec = harness.execute(b, a, time.time(), 'cpu')\n"
        "print(json.dumps(harness.result(b, rec, {})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"] == {"toy_rate": {"value": 4.0, "unit": "1/s"},
                               "setup_s": {"value": 1.5, "unit": "s"}}
