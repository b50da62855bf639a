"""The port stands alone: ``paddle_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of ``paddle_tpu``, importing the package builds
nothing, and the smoke script refuses to run without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / 'paddle_tpu_torch'
PORT_FILES = sorted(PORT.rglob('*.py')) + [REPO / 'chip_smoke.py']


def _clean_env():
    env = dict(os.environ)
    env['PYTHONPATH'] = str(REPO)
    return env


def test_import_leaves_no_jax_or_reference_module():
    code = (
        'import sys, pkgutil, importlib\n'
        'import paddle_tpu_torch\n'
        'for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n'
        '                               "paddle_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = sorted(n for n in sys.modules if n == "jax"\n'
        '             or n.startswith(("jax.", "jaxlib"))\n'
        '             or n == "paddle_tpu" or n.startswith("paddle_tpu."))\n'
        'print(len([n for n in sys.modules\n'
        '           if n.startswith("paddle_tpu_torch")]), bad)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(' ', 1)
    assert int(count) >= 64          # every module of the five slices
    assert bad.strip() == '[]'


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for name in names:
            root = name.split('.')[0]
            assert root not in ('jax', 'jaxlib', 'paddle_tpu'), (path, name)


def test_import_builds_nothing():
    """The CUDA build runs at first launch, never at import: importing every
    module starts no compiler and loads no library."""
    code = ('import pkgutil, importlib, paddle_tpu_torch\n'
            'for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n'
            '                               "paddle_tpu_torch."):\n'
            '    importlib.import_module(m.name)\n'
            'from paddle_tpu_torch.ops import _build\n'
            'print(_build.build_info, _build._libs)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ['{}', '{}']


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = _clean_env()
    env['CUDA_VISIBLE_DEVICES'] = ''
    out = subprocess.run([sys.executable, str(REPO / 'chip_smoke.py')],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and 'no CUDA device' in out.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    (tmp_path / 'chip_smoke.py').write_text(
        (REPO / 'chip_smoke.py').read_text())
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    env['CUDA_VISIBLE_DEVICES'] = ''
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
