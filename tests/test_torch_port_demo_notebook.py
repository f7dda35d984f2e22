"""The port's demo notebook (``ganspace_tpu_torch/notebooks/Ganspace_torch.ipynb``,
the counterpart of ``notebooks/Ganspace_tpu.ipynb``): committed pre-executed
on the CPU, built by ``make_demo_notebook``, free of the JAX package."""

import re
from pathlib import Path

import nbformat
import pytest
import torch

from ganspace_tpu_torch.notebooks import make_demo_notebook


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


PATH = (Path(__file__).resolve().parent.parent / "ganspace_tpu_torch" / "notebooks"
        / "Ganspace_torch.ipynb")


@pytest.fixture(scope="module")
def nb():
    return nbformat.read(PATH, as_version=4)


def _code(nb):
    return [c for c in nb.cells if c.cell_type == "code"]


def test_notebook_parses_and_validates(nb):
    nbformat.validate(nb)
    assert [c.cell_type for c in nb.cells].count("markdown") == 6
    assert len(_code(nb)) == 5
    assert "run on the CPU" in nb.cells[0].source


def test_code_cells_ran_in_order_with_images(nb):
    code = _code(nb)
    assert [c.execution_count for c in code] == list(range(1, len(code) + 1))
    for c in code:
        assert not [o for o in c.outputs if o.output_type == "error"]
    assert sum("image/png" in o.get("data", {}) for c in code for o in c.outputs) >= 2
    # the committed run was on the CPU, as its first cell says
    assert "device: cpu" in "".join(o.get("text", "") for o in code[0].outputs)


def test_build_gives_the_committed_cells(nb):
    built = make_demo_notebook.build()
    assert [c.cell_type for c in built.cells] == [c.cell_type for c in nb.cells]
    assert [c.source for c in built.cells] == [c.source for c in nb.cells]


def test_no_cell_imports_jax(nb):
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b|\bganspace_tpu\.", re.M)
    for c in _code(nb):
        assert not jax_import.search(c.source), c.source
    assert "ganspace_tpu_torch.examples" in _code(nb)[4].source
    assert 'os.environ.get("GANSPACE_DEVICE", "cuda")' in _code(nb)[0].source
