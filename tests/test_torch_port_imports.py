"""The port imports torch and never jax or ganspace_tpu, nor does a rank
that ``parallel.launch`` spawns."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


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
    "ganspace_tpu_torch.ops.prroi",
    "ganspace_tpu_torch.ops.sketch",
    "ganspace_tpu_torch.estimators",
    "ganspace_tpu_torch.estimators.utils",
    "ganspace_tpu_torch.estimators.ipca",
    "ganspace_tpu_torch.estimators.pca",
    "ganspace_tpu_torch.estimators.rsvd",
    "ganspace_tpu_torch.estimators.ica",
    "ganspace_tpu_torch.estimators.spca",
    "ganspace_tpu_torch.models",
    "ganspace_tpu_torch.models.base",
    "ganspace_tpu_torch.models.checkpoints",
    "ganspace_tpu_torch.models.torch_import",
    "ganspace_tpu_torch.models.tf_import",
    "ganspace_tpu_torch.models.stylegan",
    "ganspace_tpu_torch.models.stylegan2",
    "ganspace_tpu_torch.models.biggan",
    "ganspace_tpu_torch.models.proggan",
    "ganspace_tpu_torch.models.dcgan",
    "ganspace_tpu_torch.models.imagenet_classes",
    "ganspace_tpu_torch.models._imagenet_wnids",
    "ganspace_tpu_torch.decomposition",
    "ganspace_tpu_torch.edit",
    "ganspace_tpu_torch.apps.visualize",
    "ganspace_tpu_torch.apps.interactive",
    "ganspace_tpu_torch.directions",
    "ganspace_tpu_torch.__main__",
    "ganspace_tpu_torch.utils",
    "ganspace_tpu_torch.utils.video",
    "ganspace_tpu_torch.tools",
    "ganspace_tpu_torch.tools.lightbox",
    "ganspace_tpu_torch.tools.upconv_split",
    "ganspace_tpu_torch.tools.makesample",
    "ganspace_tpu_torch.tools.ganseg",
    "ganspace_tpu_torch.tools.allunitsample",
    "ganspace_tpu_torch.native",
    "ganspace_tpu_torch.notebooks",
    "ganspace_tpu_torch.notebooks.notebook_init",
    "ganspace_tpu_torch.notebooks.run_all",
    "ganspace_tpu_torch.notebooks.figure_pca_illustration",
    "ganspace_tpu_torch.notebooks.figure_teaser",
    "ganspace_tpu_torch.notebooks.figure_pca_cleanup",
    "ganspace_tpu_torch.notebooks.figure_style_content_sep",
    "ganspace_tpu_torch.notebooks.figure_supervised_comp",
    "ganspace_tpu_torch.notebooks.figure_first_20_pcs",
    "ganspace_tpu_torch.notebooks.figure_edit_zoo",
    "ganspace_tpu_torch.notebooks.figure_biggan_style_resampling",
    "ganspace_tpu_torch.notebooks.figure_biggan_style_mixing",
    "ganspace_tpu_torch.notebooks.figure_biggan_edit_transferability",
    "ganspace_tpu_torch.utils.jobs",
    "ganspace_tpu_torch.utils.progress",
    "ganspace_tpu_torch.utils.workerpool",
    "ganspace_tpu_torch.stats",
    "ganspace_tpu_torch.stats.running",
    "ganspace_tpu_torch.dissection",
    "ganspace_tpu_torch.dissection.__main__",
    "ganspace_tpu_torch.dissection.broden",
    "ganspace_tpu_torch.dissection.dissect",
    "ganspace_tpu_torch.dissection.report",
    "ganspace_tpu_torch.dissection.runners",
    "ganspace_tpu_torch.dissection.sampler",
    "ganspace_tpu_torch.dissection.viz",
    "ganspace_tpu_torch.dissection.segmodel",
    "ganspace_tpu_torch.dissection.segmenter",
    "ganspace_tpu_torch.dissection.ace",
    "ganspace_tpu_torch.dissection.server",
    "ganspace_tpu_torch.examples",
    "ganspace_tpu_torch.examples.custom_classifier",
    "ganspace_tpu_torch.examples.custom_model",
    "ganspace_tpu_torch.examples.quickstart",
    "ganspace_tpu_torch.utils.statedict",
    "ganspace_tpu_torch.utils.tracing",
    "ganspace_tpu_torch.tools.profiling",
    "ganspace_tpu_torch.tools.profile_wpca",
    "ganspace_tpu_torch.tools.profile_convtap",
    "ganspace_tpu_torch.notebooks.make_demo_notebook",
    "ganspace_tpu_torch.parallel",
    "ganspace_tpu_torch.parallel.mesh",
]


def test_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ganspace_tpu'))\n"
        "assert not bad, bad\n"
        # a spawned rank (gloo, two CPU ranks) imports no more than the port
        "sys.path.insert(0, 'tests')\n"
        "import torch_port_mesh_jobs as jobs\n"
        "from ganspace_tpu_torch.parallel import launch\n"
        "ranks = launch(jobs.imported_modules, shape='2', devices='cpu')\n"
        "bad = sorted({m for r in ranks for m in r if m in ('jax', 'jaxlib', 'ganspace_tpu')})\n"
        "assert len(ranks) == 2 and 'ganspace_tpu_torch' in ranks[1] and not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env={
                             **os.environ, "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_lists_every_module():
    found = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "ganspace_tpu_torch").rglob("*.py"))
    assert sorted(set(MODULES) | {"ganspace_tpu_torch.ops",
                                  "ganspace_tpu_torch.apps"}) == found
