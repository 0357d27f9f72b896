"""The port's logical-axis sharding (``repro_torch.distributed.sharding``)
against the reference's: the reference's ``tests/test_sharding_rules.py``
and ``tests/test_sharding.py`` cases on the port's module, every rule set
on meshes of 1-3 axes (hypothesis over dims), ``local_shard`` against the
blocks jax's ``NamedSharding`` places on each virtual device, the
tensor-parallel placement against ``local_shard`` of ``shaped_spec`` where
the mesh divides the heads, and every config's logical axes.
"""
import numpy as np
import pytest

import jax
from hypothesis import assume, given, settings, strategies as st
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.distributed import sharding as jsh
from repro.models import common as jcm
from repro.models import dense as jdense
from repro.models import encdec as jencdec
from repro.models import rwkv6 as jrwkv6
from repro.models import zamba2 as jzamba2
from repro.models.api import build_model as j_build_model
from repro_torch.configs import all_configs, get_config, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.tp import TensorParallel
from repro_torch.launch.mesh import Mesh, chips
from repro_torch.models.api import build_model

RULE_SETS = ['TRAIN_RULES', 'SERVE_RULES', 'LONG_SERVE_RULES',
             'SERVE_DH_CONTRACT_RULES', 'SERVE_SEQ_RULES',
             'SERVE_KV_DP_RULES', 'TRAIN_NO_SP_RULES']
LOGICAL = ['batch', 'seq', 'heads', 'kv_heads', 'head_dim', 'embed',
           'ffn', 'vocab', 'qkv', 'layers', 'pages', 'kv_seq', 'expert',
           'state', None]
MESH_SHAPES = {1: [((2,), ('model',)), ((4,), ('model',))],
               2: [((2, 2), ('data', 'model')), ((1, 4), ('data', 'model'))],
               3: [((2, 2, 2), ('pod', 'data', 'model'))]}


def _port_mesh(jmesh):
    """The port's description of a jax mesh: same axes, same sizes."""
    shape = tuple(jmesh.shape[a] for a in jmesh.axis_names)
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape),
                jmesh.axis_names)


def _one_device_mesh(names):
    return jax.sharding.Mesh(
        np.asarray(jax.devices()[:1]).reshape((1,) * len(names)), names)


def test_rule_tables_are_the_reference_tables():
    for name in RULE_SETS:
        assert getattr(sh, name) == getattr(jsh, name), name
    assert sh.RULE_VARIANTS.keys() == jsh.RULE_VARIANTS.keys()
    for k, v in sh.RULE_VARIANTS.items():
        assert v == jsh.RULE_VARIANTS[k], k


# -- the reference's tests/test_sharding_rules.py cases on the port ----------
@pytest.mark.parametrize('n_axes', [1, 2, 3])
@pytest.mark.parametrize('rules', ['SERVE_RULES', 'TRAIN_RULES'])
def test_never_yields_empty_tuple_or_absent_axis(n_axes, rules):
    names = {1: ('model',), 2: ('data', 'model'),
             3: ('pod', 'data', 'model')}[n_axes]
    mesh = Mesh(np.zeros((1,) * n_axes, int), names)
    jmesh = _one_device_mesh(names)
    for a in LOGICAL:
        for b in LOGICAL:
            spec = sh.logical_to_spec((a, b), getattr(sh, rules), mesh)
            assert spec == tuple(jsh.logical_to_spec(
                (a, b), getattr(jsh, rules), jmesh))
            for part in spec:
                assert part != (), (a, b, names)
                parts = (part,) if isinstance(part, str) else (part or ())
                assert all(x in names for x in parts), (a, b, spec)


@pytest.mark.parametrize('n_axes', [1, 2, 3])
def test_all_absent_tuple_is_replicated(n_axes):
    names = {1: ('model',), 2: ('data', 'model'),
             3: ('pod', 'data', 'model')}[n_axes]
    mesh = Mesh(np.zeros((1,) * n_axes, int), names)
    spec = sh.logical_to_spec(('batch', 'heads'), sh.SERVE_RULES, mesh)
    want = {1: P(None, 'model'), 2: P('data', 'model'),
            3: P(('pod', 'data'), 'model')}[n_axes]
    assert spec == tuple(want)
    one = Mesh(np.zeros((1,), int), ('model',))
    assert sh.logical_to_spec(('batch',), sh.SERVE_RULES, one) == ()


def test_without_mesh_is_fully_replicated():
    assert sh.logical_to_spec(('batch', 'heads', 'embed'),
                              sh.SERVE_RULES) == ()
    assert sh.logical_to_spec(('batch', 'seq'), sh.TRAIN_RULES, None) == ()


def test_crafted_absent_rules():
    mesh = Mesh(np.zeros((1, 1), int), ('data', 'model'))
    rules = {'x': ('pod', 'expertpar'), 'y': 'model'}
    assert sh.logical_to_spec(('x', 'y'), rules, mesh) == (None, 'model')
    assert sh.logical_to_spec(('y', 'x'), rules, mesh) == ('model',)


# -- the reference's tests/test_sharding.py cases on the port ----------------
@pytest.fixture(scope='module')
def mesh22():
    return Mesh(np.arange(4).reshape(2, 2), ('data', 'model'))


def _axis_sizes(mesh, part):
    if part is None:
        return 1
    n = 1
    for p in ((part,) if isinstance(part, str) else part):
        n *= mesh.shape[p]
    return n


@settings(max_examples=120, deadline=None, derandomize=True)
@given(st.lists(st.sampled_from(
    [(8, 'batch'), (40, 'heads'), (8, 'kv_heads'), (128, 'head_dim'),
     (17, 'vocab'), (64, 'ffn'), (3, None), (256, 'embed'), (6, 'seq')]),
    min_size=1, max_size=4))
def test_shaped_spec_always_divides(mesh22, dims):
    shape = tuple(d for d, _ in dims)
    axes = tuple(a for _, a in dims)
    spec = sh.shaped_spec(shape, axes, sh.TRAIN_RULES, mesh22)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for dim, part in zip(shape, parts):
        assert dim % _axis_sizes(mesh22, part) == 0, (shape, axes, spec)


def test_shaped_spec_relocates_dropped_axis(mesh22):
    spec = sh.shaped_spec((4, 3, 128), ('batch', 'kv_heads', 'head_dim'),
                          sh.SERVE_RULES, mesh22)
    assert spec == ('data', None, 'model')


def test_shaped_spec_keeps_divisible_mapping(mesh22):
    spec = sh.shaped_spec((4, 8, 128), ('batch', 'kv_heads', 'head_dim'),
                          sh.SERVE_RULES, mesh22)
    assert spec == ('data', 'model')


def test_shaped_spec_partial_tuple(mesh22):
    assert sh.shaped_spec((6, 10), ('batch', None), sh.TRAIN_RULES,
                          mesh22) == ('data',)


def test_logical_to_spec_drops_missing_axes(mesh22):
    assert sh.logical_to_spec(('batch', 'heads'), sh.TRAIN_RULES,
                              mesh22) == ('data', 'model')


# -- every rule set on meshes of 1-3 axes, against the reference -------------
@pytest.mark.parametrize('n_axes', [1, 2, 3])
@pytest.mark.parametrize('rules', RULE_SETS)
def test_specs_equal_the_reference(n_axes, rules, make_virtual_mesh):
    cases = [(make_virtual_mesh(*m), m) for m in MESH_SHAPES[n_axes]]

    @settings(max_examples=40, deadline=None, derandomize=True)
    @given(st.lists(st.tuples(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 17]),
                              st.sampled_from(LOGICAL)),
                    min_size=1, max_size=5))
    def check(dims):
        shape = tuple(d for d, _ in dims)
        axes = tuple(a for _, a in dims)
        for jmesh, _ in cases:
            mesh = _port_mesh(jmesh)
            assert sh.logical_to_spec(axes, getattr(sh, rules), mesh) == \
                tuple(jsh.logical_to_spec(axes, getattr(jsh, rules), jmesh))
            assert sh.shaped_spec(shape, axes, getattr(sh, rules), mesh) == \
                tuple(jsh.shaped_spec(shape, axes, getattr(jsh, rules),
                                      jmesh))
    check()


@settings(max_examples=60, deadline=None, derandomize=True)
@given(dims=st.lists(st.tuples(st.sampled_from([2, 4, 6, 8, 16]),
                               st.sampled_from(LOGICAL)),
                     min_size=1, max_size=4),
       which=st.sampled_from([m for ms in MESH_SHAPES.values() for m in ms]),
       rules=st.sampled_from(RULE_SETS))
def test_local_shard_is_the_named_sharding_block(virtual_devices, dims,
                                                 which, rules):
    """Each device's block under jax's ``NamedSharding`` equals
    ``local_shard`` at that device's mesh coordinates."""
    shape_m, names = which
    n = int(np.prod(shape_m))
    jmesh = jax.sharding.Mesh(
        np.asarray(virtual_devices[:n]).reshape(shape_m), names)
    mesh = _port_mesh(jmesh)
    shape = tuple(d for d, _ in dims)
    axes = tuple(a for _, a in dims)
    spec = sh.shaped_spec(shape, axes, getattr(sh, rules), mesh)
    # the reference's shaped_spec may re-place a freed axis on a second
    # dimension (test_shaped_spec_can_name_an_axis_twice); jax refuses
    # such a spec, so there is no NamedSharding block to compare with
    named = [a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)]
    assume(len(named) == len(set(named)))
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    arr = jax.device_put(x, NamedSharding(jmesh, P(*spec)))
    where = {d: idx for idx, d in np.ndenumerate(jmesh.devices)}
    for shard in arr.addressable_shards:
        coords = dict(zip(names, where[shard.device]))
        np.testing.assert_array_equal(
            sh.local_shard(x, spec, mesh, coords), np.asarray(shard.data))
    assert sh.Sharding(mesh, spec).shard(x, mesh.coords(0)).shape == \
        arr.addressable_shards[0].data.shape


def test_shaped_spec_can_name_an_axis_twice(make_virtual_mesh):
    """A fault of the reference kept for parity: the re-placement of a
    freed axis ignores the axes already used, so one mesh axis can land on
    two dimensions (jax's NamedSharding refuses the spec).  The port
    reproduces it; its tensor-parallel placement never resolves a spec
    through shaped_spec."""
    jmesh = make_virtual_mesh((4,), ('model',))
    shape, axes = (2, 4, 4), ('seq', 'batch', 'seq')
    want = tuple(jsh.shaped_spec(shape, axes, jsh.TRAIN_RULES, jmesh))
    assert want == (None, 'model', 'model')
    assert sh.shaped_spec(shape, axes, sh.TRAIN_RULES,
                          _port_mesh(jmesh)) == want


def test_axis_rules_context_and_constrain():
    mesh = Mesh(np.arange(2), ('model',))
    x = np.ones((2, 4))
    assert sh._current() is None
    with sh.axis_rules(mesh, sh.SERVE_RULES):
        assert sh._current() == (mesh, sh.SERVE_RULES)
        assert sh.constrain(x, ('batch', 'heads')) is x
        with sh.axis_rules(None, sh.SERVE_RULES):
            assert sh._current() is None
    assert sh._current() is None
    assert sh.constrain(x, ('batch', 'heads')) is x


def test_tree_specs():
    model = build_model(reduced(get_config('qwen3-0.6b')))
    mesh = Mesh(np.arange(2), ('model',))
    tree = sh.tree_spec(model.param_axes(), sh.SERVE_RULES, mesh)
    assert tree['layers']['wq'] == sh.Sharding(mesh, (None, None, 'model'))
    shaped = sh.tree_spec_shaped(model.param_axes(), model.template(),
                                 sh.SERVE_RULES, mesh)
    assert shaped['embed'].spec == ('model',)
    assert shaped['final_norm'].spec == ()
    assert chips(mesh) == 2 and chips(None) == 1
    grid = Mesh(np.arange(6).reshape(2, 3), ('data', 'model'), rank=5)
    assert grid.coords() == {'data': 1, 'model': 2} == grid.coords(5)
    assert grid.coord('model') == 2 and grid.size == 6
    assert grid.shape == {'data': 2, 'model': 3}
    with pytest.raises(RuntimeError, match='no groups'):
        grid.group('model')


# -- the tensor-parallel placement ------------------------------------------
@pytest.mark.parametrize('heads,kv,n', [(16, 8, 2), (16, 8, 4), (4, 2, 2),
                                        (8, 2, 2), (32, 8, 8)])
def test_placement_is_shaped_spec_where_the_mesh_divides_the_heads(
        heads, kv, n):
    """Where ``model`` divides the kv-heads, d_ff and the vocabulary, each
    rank's weight blocks are ``local_shard`` of ``shaped_spec`` under
    SERVE_RULES: the placement differs from the rules only where they would
    split a head."""
    import torch
    cfg = reduced(get_config('qwen3-0.6b'), n_heads=heads, n_kv_heads=kv,
                  d_ff=128, vocab_size=512)
    model = build_model(cfg)
    params = model.init_params(0, device='cpu')
    mesh = Mesh(np.arange(n), ('model',))
    axes, shapes = model.param_axes(), model.param_shapes()
    for r in range(n):
        tp = TensorParallel(cfg, mesh, {'model': r})
        blocks = tp.shard_params(params)
        for k, w in params['layers'].items():
            spec = sh.shaped_spec(shapes['layers'][k], axes['layers'][k],
                                  sh.SERVE_RULES, mesh)
            want = sh.local_shard(w.detach(), spec, mesh, {'model': r})
            assert torch.equal(blocks['layers'][k], want), (k, r)
        spec = sh.shaped_spec(shapes['embed'], axes['embed'],
                              sh.SERVE_RULES, mesh)
        assert torch.equal(blocks['embed'], sh.local_shard(
            params['embed'].detach(), spec, mesh, {'model': r}))


# -- logical axes of every config -------------------------------------------
def _j_axes(tmpl):
    return jcm.axes_from_template(tmpl)


def _head_axes(tree):
    """The port keeps each head (V, D): the reference's (D, V) axes
    reversed."""
    def fix(node, key=None):
        if isinstance(node, dict):
            return {k: fix(v, k) for k, v in node.items()}
        return tuple(reversed(node)) if key == 'unembed' else node
    return fix(tree)


@pytest.mark.parametrize('arch', sorted(all_configs()))
def test_param_and_cache_axes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    model, jmodel = build_model(cfg), j_build_model(jcfg)
    assert model.param_axes() == _head_axes(jmodel.param_axes())
    fam = cfg.family
    if fam in ('dense', 'vlm', 'moe'):
        want = jmodel.cache_axes(None, engine_pages=33)
        got = model.cache_axes(engine_pages=33)
    elif fam == 'ssm':
        want = _j_axes(jrwkv6.cache_template(jcfg, 3))
        got = model.cache_axes(batch_size=3)
    elif fam == 'hybrid':
        want = {'mamba': _j_axes(jzamba2.mamba_cache_template(jcfg, 3)),
                'attn': _j_axes(jzamba2.attn_cache_template(jcfg, 33))}
        got = model.cache_axes(engine_pages=33, batch_size=3)
        assert model.cache_axes(batch_size=3, max_seq=64)['attn'] == \
            _j_axes(jzamba2.attn_cache_template_dense(jcfg, 3, 64))
    else:
        want = _j_axes(jencdec.cache_template(jcfg, 33, 3, 40))
        got = model.cache_axes(engine_pages=33, batch_size=3, enc_len=40)
    assert got == want
    if fam in ('dense', 'vlm', 'moe'):
        assert got == _j_axes(jdense.cache_template(jcfg, 33))
    shapes = model.param_shapes()
    assert shapes['embed'] == (cfg.vocab_size, cfg.d_model)


# -- blocks of several intervals (zamba2's packed leaves) -------------------
def test_block_of_several_intervals_takes_cuts_and_splits_into_pieces():
    import torch

    full = np.arange(4 * 10).reshape(4, 10)
    b = sh.Block.whole((4, 10)).select(1, ((0, 2), (5, 7), (9, 10)))
    b = b.narrow(0, 1, 3)
    assert b.bounds == ((1, 3), ((0, 2), (5, 7), (9, 10)))
    assert b.local_shape == (2, 5) and not b.is_whole()
    want = full[1:3][:, [0, 1, 5, 6, 9]]
    np.testing.assert_array_equal(b.take(full), want)
    assert torch.equal(b.take(torch.from_numpy(full)), torch.from_numpy(want))
    # one interval stays a pair, and takes a view
    one = b.select(1, ((5, 7),))
    assert one.bounds[1] == (5, 7) and one.intervals(1) == ((5, 7),)
    assert np.shares_memory(one.take(full), full)
    # cut along a dimension of one interval keeps the others
    assert b.cut(0, 2, 1).bounds == ((2, 3), b.bounds[1])
    with pytest.raises(ValueError, match='several intervals'):
        b.cut(1, 5, 0)
    with pytest.raises(ValueError, match='disjoint'):
        b.select(1, ((0, 3), (2, 4)))
    pieces = b.pieces()
    assert [p.bounds for p, _ in pieces] == [
        ((1, 3), (0, 2)), ((1, 3), (5, 7)), ((1, 3), (9, 10))]
    local = b.take(full)
    for p, idx in pieces:
        np.testing.assert_array_equal(local[idx], p.take(full))
    assert sh.Block.whole((4, 10)).is_whole()


def test_block_of_several_intervals_round_trips_a_checkpoint(tmp_path):
    """A leaf written as a block of two intervals (two shards) restores
    whole, onto another block of several intervals, and through the
    reference's ``restore``."""
    import torch

    from repro.training import checkpoint as jckpt
    from repro_torch.training import checkpoint as ckpt

    full = np.random.default_rng(0).standard_normal((3, 10)).astype(
        np.float32)
    wrote = sh.Block.whole((3, 10)).select(1, ((0, 4), (4, 10)))
    tree = {'w': torch.from_numpy(wrote.take(full))}
    d = ckpt.save(str(tmp_path), 1, tree, specs={'w': wrote})
    import json
    import os
    with open(os.path.join(d, 'manifest.json')) as f:
        assert len(json.load(f)['leaves']['w']['shards']) == 2
    whole, step = ckpt.restore(str(tmp_path), 1,
                               {'w': torch.zeros(3, 10)})
    assert step == 1 and torch.equal(whole['w'], torch.from_numpy(full))
    other = sh.Block.whole((3, 10)).select(1, ((1, 2), (3, 8))).narrow(
        0, 1, 3)
    part, _ = ckpt.restore(str(tmp_path), 1, {'w': torch.zeros(2, 6)},
                           shardings={'w': other})
    assert torch.equal(part['w'], torch.from_numpy(other.take(full)))
    ref, _ = jckpt.restore(str(tmp_path), 1, {'w': np.zeros((3, 10),
                                                            np.float32)})
    np.testing.assert_array_equal(np.asarray(ref['w']), full)


# -- the training families' placement ----------------------------------------
FAMILY_REPLICATED = {
    'rwkv6-3b': {'final_norm', 'layers/ln1', 'layers/ln2', 'layers/mu',
                 'layers/w_A', 'layers/mu_cm', 'layers/w_base',
                 'layers/w_B', 'layers/ln_x'},
    'zamba2-2.7b': {'final_norm', 'layers/ln', 'shared/ln1', 'shared/ln2'},
    'seamless-m4t-medium': {
        'frontend_proj', 'enc_final_norm', 'final_norm', 'enc_layers/ln1',
        'enc_layers/ln2', 'dec_layers/ln1', 'dec_layers/ln2',
        'dec_layers/ln_cross'}}


def _flat_indices(block) -> list:
    return block.take(np.arange(int(np.prod(block.shape))).reshape(
        block.shape)).ravel().tolist()


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('arch', sorted(FAMILY_REPLICATED))
def test_family_placement_partitions_every_split_leaf(arch, n):
    """Over ``model`` = n, every leaf of the reduced rwkv6, zamba2 and
    seamless is replicated (the listed ones) or split into disjoint blocks
    that cover it; a kv-head block held by several ranks (seamless at
    n = 4: 2 kv-heads) counts on its first holder (``duplicate``)."""
    from repro_torch.training import tree as tr

    cfg = reduced(get_config(arch))
    shapes = dict(tr.leaves_with_paths(build_model(cfg).param_shapes()))
    mesh = Mesh(np.arange(n), ('model',))
    tps = [TensorParallel(cfg, mesh, {'model': r}) for r in range(n)]
    replicated = set()
    for k, shp in shapes.items():
        blocks = [tp.block(k, shp) for tp in tps]
        if all(b.is_whole() for b in blocks):
            replicated.add(k)
            continue
        held = [i for tp, b in zip(tps, blocks) if not tp.duplicate(k)
                for i in _flat_indices(b)]
        assert sorted(held) == list(range(int(np.prod(shp)))), k
    assert replicated == FAMILY_REPLICATED[arch]
    if arch.startswith('seamless') and n == 4:
        assert tps[0].kv_holders == 2 and tps[1].duplicate('dec_layers/xwk')


def test_family_tables_key_on_the_path():
    """zamba2's ``in_proj`` / ``conv`` hold a rank's heads and its share of
    B and C in global order, its 2-D shared block splits by its own heads
    (width 2 d_model / heads), and seamless's cross-attention leaves split
    as its self-attention's."""
    cfg = reduced(get_config('zamba2-2.7b'))      # d_in 128, N 8, 8 heads
    tp = TensorParallel(cfg, Mesh(np.arange(2), ('model',)), {'model': 1})
    assert tp.ranges('layers/in_proj') == {2: (
        (64, 128), (192, 256), (260, 264), (268, 272), (276, 280))}
    assert tp.ranges('layers/conv_w') == {2: ((64, 128), (132, 136),
                                              (140, 144))}
    assert tp.ranges('layers/A_log') == {1: ((4, 8),)}
    assert tp.ranges('shared/wq') == {1: ((64, 128),)}
    assert tp.ranges('shared/wd') == {0: ((64, 128),)}
    cfg = reduced(get_config('seamless-m4t-medium'))
    tp = TensorParallel(cfg, Mesh(np.arange(2), ('model',)), {'model': 1})
    for k in ('wq', 'wk', 'wv', 'wo', 'bq', 'bk', 'bv'):
        assert tp.ranges(f'dec_layers/x{k}') == tp.ranges(f'dec_layers/{k}')
        assert tp.ranges(f'dec_layers/x{k}')
    assert tp.ranges('frontend_proj') == {}
