"""Paper Table 1 deployability claim, held for the port's engine
(``src/repro_torch/serving/engine.py``): the framework-side integration is
one invalidation callback of at most 13 LOC between the ``VALVE-PATCH``
markers, plus fewer than 10 ``# VALVE-SESSION`` call sites."""
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENGINES = {'port': ROOT / 'src/repro_torch/serving/engine.py',
           'reference': ROOT / 'src/repro/serving/engine.py'}
MARKERS = r'# >>> VALVE-PATCH-BEGIN\n(.*?)# >>> VALVE-PATCH-END'
SESSION_TAG = '# VALVE-SESSION'


def _patch_body(path: Path) -> str:
    m = re.search(MARKERS, path.read_text(), re.S)
    assert m, 'patch markers missing'
    return m.group(1)


def patch_loc(path: Path) -> int:
    """Non-comment, non-blank LOC between the VALVE-PATCH markers."""
    return len([l for l in _patch_body(path).splitlines()
                if l.strip() and not l.strip().startswith('#')])


def session_patch_loc(path: Path) -> int:
    return len([l for l in path.read_text().splitlines()
                if l.rstrip().endswith(SESSION_TAG)])


def test_engine_patch_at_most_13_loc():
    n = patch_loc(ENGINES['port'])
    assert 0 < n <= 13, f'patch is {n} LOC'


def test_patch_is_single_callback():
    assert re.findall(r'def (\w+)', _patch_body(ENGINES['port'])) == \
        ['on_pages_invalidated']


def test_patch_is_the_reference_patch():
    """The port changes nothing inside the patch: same lines of code."""
    assert _patch_body(ENGINES['port']) == _patch_body(ENGINES['reference'])


@pytest.mark.parametrize('limit', [10])
def test_session_integration_is_a_handful_of_lines(limit):
    n = session_patch_loc(ENGINES['port'])
    assert 0 < n < limit, f'session integration is {n} tagged lines'
    assert n == session_patch_loc(ENGINES['reference'])


def test_combined_surface_under_20_loc():
    path = ENGINES['port']
    assert patch_loc(path) + session_patch_loc(path) < 25


def test_no_legacy_runtime_calls_in_engine():
    src = ENGINES['port'].read_text()
    for banned in ('bind_invalidation', 'unbind_invalidation',
                   'alloc_online', 'alloc_offline', 'free_online',
                   'free_offline', 'runtime.stats', 'lifecycle.stats'):
        assert banned not in src, f'engine still calls {banned}'
