"""The port imports no jax: every module of ``s3gaussian_tpu_torch`` (and
``chip_smoke.py``) imports in a subprocess where ``import jax`` fails."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "s3gaussian_tpu_torch"


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_every_port_module_imports_without_jax():
    mods = port_modules()
    assert "s3gaussian_tpu_torch.ops.tile_kernels" in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"       # any `import jax` raises
            "import importlib\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_jax_import_in_port_sources():
    for p in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or s.startswith("from s3gaussian_tpu.ops")
                        or s.startswith("from s3gaussian_tpu.models")
                        or s.startswith("from s3gaussian_tpu.data")), (p, s)
