"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under benchmark/, and nothing of the program under
benchmark/reference/. Names are compared by their whole top-level part:
the program's name, mm_distillnet_torch, begins with the JAX package's."""
import ast
from pathlib import Path

from benchmark.common import FORBIDDEN_MODULES, forbidden_loaded

HERE = Path(__file__).resolve().parents[1]
PROGRAM = 'mm_distillnet_torch'


def imported_tops(path: Path):
    """The top-level names of every module a file imports (relative
    imports stay inside the benchmark and are left out)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.', 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.', 1)[0]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, 'attr', None) == 'import_module' and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split('.', 1)[0]


def test_no_module_under_benchmark_imports_jax():
    files = sorted(HERE.rglob('*.py'))
    assert len(files) > 20
    for path in files:
        tops = set(imported_tops(path))
        assert not tops & set(FORBIDDEN_MODULES), (path, tops)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / 'reference').rglob('*.py')):
        assert PROGRAM not in set(imported_tops(path)), path


def test_the_comparison_is_by_whole_top_level_names():
    assert imported_tops.__name__
    assert forbidden_loaded(['mm_distillnet_torch', 'mm_distillnet_torch.ops',
                             'jaxtyping', 'flaxen.x']) == []
    assert forbidden_loaded(['jax.numpy', 'mm_distillnet_tpu.models',
                             'torch']) == ['jax', 'mm_distillnet_tpu']


def test_the_scan_sees_every_kind_of_import(tmp_path):
    f = tmp_path / 'm.py'
    f.write_text('import jax.numpy as jnp\nfrom flax import linen\n'
                 'from . import sibling\n'
                 "importlib.import_module('mm_distillnet_tpu.x')\n")
    assert set(imported_tops(f)) == {'jax', 'flax', 'mm_distillnet_tpu'}
