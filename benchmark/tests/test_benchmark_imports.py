"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``s3gaussian_tpu_torch`` is the port), and the
plain reference imports nothing of the port."""

from __future__ import annotations

import os
import subprocess
import sys

from benchmark.tests.tiny import REPO

BLOCKER = r'''
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "s3gaussian_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
'''


def _modules(sub=""):
    base = os.path.join(REPO, "benchmark", sub)
    out = []
    for d, _, files in os.walk(base):
        if "tests" in d.split(os.sep) or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py") and "." not in f[:-3]:
                rel = os.path.relpath(os.path.join(d, f), REPO)[:-3]
                out.append(rel.replace(os.sep, ".").replace(".__init__", ""))
    return sorted(out)


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_no_module_loads_jax():
    mods = _modules()
    assert "benchmark.run" in mods and "benchmark.harness.train" in mods
    code = BLOCKER + "\n".join(f"import {m}" for m in mods) + r'''
import benchmark.harness.train as t, benchmark.run as r
b = r.Bench()
for m in b.spec["per_layer"]:
    b.reader(m["name"])
import s3gaussian_tpu_torch.train_cli, s3gaussian_tpu_torch.train.graphs
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("ok")
'''
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]


def test_reference_imports_nothing_of_the_port():
    """The frozen modules, and the reference field and work count that
    each configuration names (and the toy field's), built at a tiny
    size."""
    mods = _modules("frozen")
    assert "benchmark.frozen.reference" in mods
    code = "import sys\n" + "\n".join(f"import {m}" for m in mods) + r'''
import benchmark.harness.clip
import torch
from benchmark import run
from benchmark.frozen import fields, reference
from benchmark.tests.tiny import TOY_FIELD
b = run.Bench()
configs = [b.config(c["name"]) for c in b.spec["configs"]]
configs.append(dict(configs[0], field=TOY_FIELD))
for config in configs:
    model = dict(config["model"], multires=[1], kplanes_config=dict(
        config["model"]["kplanes_config"], resolution=[4, 4, 4, 3]))
    config = dict(config, model=model)
    fields.reference(config, reference.settings(config)[0],
                     torch.Generator().manual_seed(0), "cpu")
    fields.row_ops(config)
bad = [m for m in sys.modules if m.split(".")[0] in
       ("s3gaussian_tpu_torch", "s3gaussian_tpu", "jax")]
assert not bad, bad
print("ok")
'''
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]
