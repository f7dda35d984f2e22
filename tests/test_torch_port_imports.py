"""The port imports torch and never jax or ganspace_tpu."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

MODULES = [
    "ganspace_tpu_torch",
    "ganspace_tpu_torch.config",
    "ganspace_tpu_torch.sampling",
    "ganspace_tpu_torch.imaging",
    "ganspace_tpu_torch.ops.precision",
    "ganspace_tpu_torch.ops._build",
    "ganspace_tpu_torch.ops.moments",
    "ganspace_tpu_torch.ops.modconv",
    "ganspace_tpu_torch.ops.linear",
    "ganspace_tpu_torch.ops.upfirdn",
    "ganspace_tpu_torch.ops.tf32x3",
    "ganspace_tpu_torch.estimators",
    "ganspace_tpu_torch.estimators.utils",
    "ganspace_tpu_torch.estimators.ipca",
    "ganspace_tpu_torch.models",
    "ganspace_tpu_torch.models.base",
    "ganspace_tpu_torch.models.checkpoints",
    "ganspace_tpu_torch.models.torch_import",
    "ganspace_tpu_torch.models.tf_import",
    "ganspace_tpu_torch.models.stylegan",
    "ganspace_tpu_torch.models.stylegan2",
    "ganspace_tpu_torch.decomposition",
    "ganspace_tpu_torch.edit",
    "ganspace_tpu_torch.apps.visualize",
    "ganspace_tpu_torch.utils",
    "ganspace_tpu_torch.utils.video",
    "ganspace_tpu_torch.tools",
    "ganspace_tpu_torch.tools.lightbox",
]


def test_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ganspace_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_lists_every_module():
    found = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "ganspace_tpu_torch").rglob("*.py"))
    assert sorted(set(MODULES) | {"ganspace_tpu_torch.ops",
                                  "ganspace_tpu_torch.apps"}) == found
