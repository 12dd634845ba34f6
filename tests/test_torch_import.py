"""The port imports neither jax nor anything of the JAX package: every
module of ``s3gaussian_tpu_torch`` (and ``chip_smoke.py``) imports in a
subprocess where ``import jax`` and ``import s3gaussian_tpu`` fail, and no
source line imports either."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "s3gaussian_tpu_torch"
# `import jax...`, `from jax...`, `import s3gaussian_tpu[.x]`,
# `from s3gaussian_tpu[.x] import` — not s3gaussian_tpu_torch
FORBIDDEN = re.compile(r"^(import|from)\s+(jax\b|s3gaussian_tpu(?!_torch)\b)")


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_every_port_module_imports_without_jax():
    mods = port_modules()
    assert "s3gaussian_tpu_torch.ops.tile_kernels" in mods
    assert "s3gaussian_tpu_torch.train.trainer" in mods
    assert "s3gaussian_tpu_torch.ops.compact" in mods
    for m in ("metrics", "lpips", "flow", "video", "visualization"):
        assert f"s3gaussian_tpu_torch.eval.{m}" in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"       # any `import jax` raises
            "sys.modules['s3gaussian_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and "
            "(k == 'jax' or k.startswith('jax.') or k == 's3gaussian_tpu' "
            "or k.startswith('s3gaussian_tpu.'))]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_jax_import_in_port_sources():
    assert FORBIDDEN.match("from s3gaussian_tpu.config import X")
    assert FORBIDDEN.match("import s3gaussian_tpu")
    assert FORBIDDEN.match("import jax.numpy as jnp")
    assert not FORBIDDEN.match("from s3gaussian_tpu_torch.ops import knn")
    for p in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            assert not FORBIDDEN.match(line.strip()), (p, line)
