"""No module of the benchmark imports JAX, Flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain references import nothing of the port."""

import ast
import os

from benchmark import run

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'megadetector_tpu'}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def _sources():
    for root, _, files in os.walk(run.BENCH_DIR):
        for name in files:
            if name.endswith('.py'):
                yield os.path.join(root, name)


def test_no_jax_anywhere():
    found = {p: FORBIDDEN & set(_imports(p)) for p in _sources()}
    assert not {p: f for p, f in found.items() if f}


def test_loaded_modules_compared_by_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, 'megadetector_tpu_torch_fake.x',
                        types.ModuleType('x'))
    assert 'megadetector_tpu' not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, 'megadetector_tpu.models',
                        types.ModuleType('models'))
    assert 'megadetector_tpu' in run.forbidden_loaded()


def test_references_stand_alone():
    ref = os.path.join(run.BENCH_DIR, 'reference')
    for name in os.listdir(ref):
        if name.endswith('.py'):
            mods = set(_imports(os.path.join(ref, name)))
            assert not mods & (FORBIDDEN | {'megadetector_tpu_torch'}), name
