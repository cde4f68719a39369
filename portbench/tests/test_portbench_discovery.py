"""A configuration, a mix, a driver and a metric added as new files (and
manifest entries) in a copy of the benchmark are found by name, with no
file of the harness edited."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

import tinycells
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


# A model type that is a copy of stablelm.py with stand-in sizes of its
# own: a reference module with its TINY, a configuration, a cell and its
# limits, as a configuration of a new model type brings them.
OWN_TINY = """
TINY = dict(hidden_size=48, num_attention_heads=3, num_key_value_heads=3,
            head_dim=16, intermediate_size=96, vocab_size=128,
            num_hidden_layers=3)
"""


def test_a_model_type_is_files_alone(tmp_path):
    src = str(tmp_path / "checkout")
    os.mkdir(src)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), src)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(src, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = os.path.join(src, "portbench")
    with open(os.path.join(bench, "reference", "stablelm.py")) as f:
        module = f.read() + OWN_TINY
    with open(os.path.join(bench, "reference", "lmcopy.py"), "w") as f:
        f.write(module)
    conf = json.load(open(os.path.join(bench, "configs", "stablelm3b.json")))
    conf["model_type"] = "lmcopy"
    json.dump(conf, open(os.path.join(bench, "configs", "lmcopy.json"), "w"))
    shutil.copy(os.path.join(bench, "limits", "stablelm3b-train-4k.json"),
                os.path.join(bench, "limits", "lmcopy-train-1k.json"))
    path = os.path.join(src, "BENCHMARK.json")
    m = json.load(open(path))
    m["configs"].append({"name": "lmcopy", "source": conf["source"],
                         "file": "portbench/configs/lmcopy.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "lmcopy-train-1k", "config": "lmcopy",
                           "traffic": "train-s1024-b8", "chips": 1,
                           "why": "a test"})
    json.dump(m, open(path, "w"))
    # the checkout's own tinycells shrinks every configuration, the new
    # one by its module's TINY, and the tiny driver runs the new cell
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{src!r}, {os.path.join(bench, 'tests')!r}, "
        f"{os.path.join(ROOT, 'src')!r}]\n"
        "import tinycells\n"
        "from portbench import harness\n"
        f"root = tinycells.tiny_root({str(tmp_path / 'tiny')!r})\n"
        "b = harness.Bench(root)\n"
        "c = b.config('lmcopy')\n"
        "print('SIZE', c['hidden_size'], c['num_hidden_layers'])\n"
        "for fault in (None, 'half_batch'):\n"
        "    a = harness.parse(['--workload', 'lmcopy-train-1k', '--seed', "
        "'2147483725', '--seconds', '0.2', '--trace', '0'])\n"
        "    rec = harness.execute(b, a, time.time(), 'cpu', fault)\n"
        "    out = harness.result(b, rec, {'platform': 'cpu'})\n"
        "    print('RESULT', json.dumps(out))\n")
    os.mkdir(tmp_path / "tiny")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=src)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "SIZE 48 3" in lines
    sound, fault = (json.loads(x.split(" ", 1)[1]) for x in lines
                    if x.startswith("RESULT "))
    assert sound["correct"] is True, sound["checks"]
    assert fault["correct"] is False, fault["checks"]


def test_a_model_type_without_tiny_is_named(monkeypatch):
    fam = types.ModuleType("portbench.reference.notiny")
    monkeypatch.setitem(sys.modules, fam.__name__, fam)
    with pytest.raises(LookupError, match="portbench.reference.notiny"):
        tinycells.shrink_config({"model_type": "notiny"})
