"""The port's dry-run (``repro_torch.launch.dryrun``,
``launch/op_analysis.py``) against the reference's (``repro.launch.dryrun``,
``launch/hlo_analysis.py``).

- ``op_analysis`` units, as ``tests/test_hlo_analysis.py`` does them for
  the HLO parser: ``wire_factor`` equal to the reference's for every kind
  and group size 1..16; the product FLOPs of known ops; slice-aware
  traffic; a masked selection counted at its upper bound; the collectives
  of a fake process group; the peak of live intermediates; reads.
- Per-cell parity at ``reduced()`` widths, every family x {prefill,
  decode, train}: meshless, and on a (data 2, model 2) mesh (the
  reference's over 4 of the conftest's virtual devices, an Auto-axis
  ``Mesh``) for every family's train cell and the serve cells of dense,
  moe, ssm, hybrid and encdec, and the train cells of dense, ssm and
  hybrid under ``serve_dh`` and ``serve_kv_dp`` (the reference's
  ``make_train_step(rules=)``).  The argument bytes under the reference's
  specs (meshless: ``hbm.argument``) equal the compiled program's
  ``argument_size_in_bytes`` exactly.  ``flops_per_device`` is within 10 %
  of ``hlo_analysis.analyze(...).flops`` for prefill and decode and 15 %
  for train.  The gaps over 1 %, op by op:

  * zamba2 (every kind, both layouts): the reference applies its shared
    block under ``lax.cond``, and ``hlo_analysis`` counts every branch of
    an HLO conditional at each of the scan's trips, so it counts the
    block's products (``wq``/``wk``/``wv``/``wo``, its attention, its
    SwiGLU, and their backward) at all ``n_layers`` layers, where the
    program runs them at every ``hybrid_attn_every``-th (the port counts
    0.62-0.69 of the reference).  The test holds the port's count of the
    same config with the block at every layer (``hybrid_attn_every=1``)
    to the reference's count: within 0.4 %.
  * zamba2 prefill on (2, 2): B and C are gathered over ``model`` after
    the conv (every head's SSD reads all of N), so each rank computes the
    chunked SSD's C B^T (a c x c product a chunk over all N) whole, where
    GSPMD splits that contraction over N and sums it over ``model``: the
    port counts (model - 1) / model of that product more
    (:func:`_replicated_cb_flops`, 2^20 FLOPs here, 0.58 % of the cell),
    which the test subtracts before the 0.4 % check.
  * rwkv6 train on (2, 2): the port counts 1.014 of the reference, under
    ``TRAIN_RULES`` and ``TRAIN_NO_SP_RULES`` alike.

- Production cells at full width, shape-only: every family's decode_32k
  and train_4k cell on the (16, 16) mesh and one (2, 16, 16) cell:
  ``ok`` (no family is refused on a mesh), and for every ``ok`` train or
  prefill cell ``flops_per_device x chips >= 0.95 model_flops``.  The
  sweep's cells, under every rule variant, are counted or skipped by
  ``cell_supported`` alone; and the CLI prints a record with the
  reference's keys.  ``hbm.argument`` counts the rank's own
  blocks (``arguments``); where they differ from the reference's specs
  (``reference_arguments``, which the per-cell parity compares) the record
  would name the leaves that differ, with both byte counts
  (``placement``): no cell does.  Where ``model`` = 16 does not divide the
  attention heads (seven architectures), rwkv6-3b's 40 wkv heads or
  seamless-m4t-medium's vocabulary, a serve cell's rank holds the
  reference's blocks leaf for leaf under the default rules, ``serve_seq``
  and ``serve_kv_dp`` (and ``serve_dh`` for the last two); so do
  rwkv6-3b's and zamba2-2.7b's long_500k cells under every variant (the
  one row, which no batch axis divides, and the batch axes moved onto the
  recurrent states and the long KV as the reference's ``shaped_spec``
  moves them), and every train cell (the sequence over ``model`` under
  ``TRAIN_RULES``).
"""
import dataclasses
import functools
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.distributed.sharding import RULE_VARIANTS as J_RULE_VARIANTS
from repro.launch import hlo_analysis as ha
from repro.launch.dryrun import opt_state_sds
from repro.models.api import build_model as j_build_model
from repro.training import train_step as jts
from repro_torch.configs import SHAPES, cell_supported, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import op_analysis as oa
from repro_torch.models import common as cm
from repro_torch.training import train_step as ts

FAMILIES = {'dense': 'qwen3-0.6b', 'vlm': 'llava-next-mistral-7b',
            'moe': 'phi3.5-moe-42b-a6.6b', 'ssm': 'rwkv6-3b',
            'hybrid': 'zamba2-2.7b', 'encdec': 'seamless-m4t-medium'}
KINDS = ('prefill', 'decode', 'train')
FLOP_TOL = {'prefill': 0.10, 'decode': 0.10, 'train': 0.15}
HYBRID_TOL = 0.004             # the block at every layer, on both sides
MESH = ((2, 2), ('data', 'model'))
# the reference's serving rule variants, under which every kind counts
VARIANTS = ('serve_dh', 'serve_kv_dp', 'serve_seq')
RECORD_KEYS = {'arch', 'shape', 'mesh', 'kind', 'microbatches',
               'rules_variant', 'status', 'chips', 'flops_per_device',
               'bytes_per_device', 'hbm', 'collectives', 'roofline',
               'model_flops', 'useful_flops_ratio', 'trace_s'}
HBM_KEYS = {'argument', 'output', 'temp', 'alias', 'peak'}
META = torch.device('meta')
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}
COMPILE_THREADS = 4            # XLA's compiles run outside the GIL


def _overrides(family, mesh):
    # the mesh cells' MoE at 16 experts (8 a rank), as the mesh tests
    return dict(n_experts=16) if family == 'moe' and mesh else {}


def _cell(family, kind, mesh):
    """(reference config, port config, reference shape, port shape)."""
    arch = FAMILIES[family]
    kw = _overrides(family, mesh)
    jcfg = j_reduced(j_get_config(arch), **kw)
    tcfg = reduced(get_config(arch), **kw)
    s = 256 if family == 'encdec' else (128 if mesh else 64)
    b = 4 if mesh else 2
    return jcfg, tcfg, JShape('cell', s, b, kind), ShapeConfig('cell', s, b,
                                                                kind)


def _reference(family, kind, mesh: bool):
    """(argument_size_in_bytes, hlo_analysis FLOPs) of the reference's
    compiled step.  The first call starts the compiles of every cell of its
    group (meshless, or the mesh cells) on a few threads."""
    if mesh and len(jax.devices()) < 4:
        pytest.skip(f'need 4 virtual devices, have {len(jax.devices())}')
    return _references(mesh)[family, kind].result()


@functools.lru_cache(maxsize=None)
def _references(mesh: bool):
    cells = (MESH_CELLS + VARIANT_TRAIN_CELLS if mesh else
             [(f, k) for f in FAMILIES for k in KINDS])
    pool = ThreadPoolExecutor(COMPILE_THREADS)
    futures = {c: pool.submit(_compile_reference, *c[:2], mesh, *c[2:])
               for c in cells}
    pool.shutdown(wait=False)
    return futures


def _compile_reference(family, kind, mesh: bool, variant='default'):
    jcfg, _, shape, _ = _cell(family, kind, mesh)
    model = j_build_model(jcfg)
    jmesh = None
    if mesh:
        from jax.sharding import Mesh
        jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(MESH[0]), MESH[1])
    if kind == 'train':
        step, _ = jts.make_train_step(model, jmesh,
                                      rules=J_RULE_VARIANTS[variant])
        if jmesh is not None:
            step = step(shape)
        args = (model.param_shapes(), opt_state_sds(model.param_shapes()),
                model.input_specs(shape))
    else:
        step, _ = jts.make_serve_step(model, jmesh, shape)
        args = (model.param_shapes(), model.cache_shapes(shape),
                model.input_specs(shape))
    # LLVM's optimization of the CPU code changes neither the optimized HLO
    # that hlo_analysis reads nor the buffer assignment: skipped for time
    compiled = step.lower(*args).compile(FAST_COMPILE)
    return (int(compiled.memory_analysis().argument_size_in_bytes),
            ha.analyze(compiled.as_text()).flops)


def _record(family, kind, mesh, **cfg_kw):
    _, tcfg, _, shape = _cell(family, kind, mesh)
    rec = dryrun.cell_record(dataclasses.replace(tcfg, **cfg_kw), shape,
                             MESH if mesh else None)
    assert rec['status'] == 'ok', rec
    return rec


# ---------------------------------------------------------------------------
# op_analysis units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ha.COLLECTIVE_KINDS + ('other',))
def test_wire_factor_is_the_reference_s(kind):
    for n in range(1, 17):
        assert oa.wire_factor(kind, n) == ha.wire_factor(kind, n), (kind, n)


def _count(fn):
    with oa.OpCounter() as c:
        fn()
    return c.costs


def _t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.mark.parametrize('case,want', [
    ('mm', 2 * 3 * 5 * 4), ('addmm', 2 * 3 * 5 * 4),
    ('bmm', 2 * 7 * 3 * 5 * 4), ('baddbmm', 2 * 7 * 3 * 5 * 4),
    ('einsum', 2 * 2 * 6 * 3 * 5 * 4), ('conv', 2 * (2 * 8 * 6 * 6) * 3 * 9),
    ('elementwise', 0)])
def test_product_flops_of_known_ops(case, want):
    a, b = _t(3, 4), _t(4, 5)
    fn = {
        'mm': lambda: a @ b,
        'addmm': lambda: torch.addmm(_t(5), a, b),
        'bmm': lambda: torch.bmm(_t(7, 3, 4), _t(7, 4, 5)),
        'baddbmm': lambda: torch.baddbmm(_t(7, 3, 5), _t(7, 3, 4),
                                         _t(7, 4, 5)),
        'einsum': lambda: torch.einsum('bhqd,bhkd->bhqk', _t(2, 6, 3, 4),
                                       _t(2, 6, 5, 4)),
        'conv': lambda: torch.nn.functional.conv2d(_t(2, 3, 8, 8),
                                                   _t(8, 3, 3, 3)),
        'elementwise': lambda: (a * 2 + 1).exp(),
    }[case]
    assert _count(fn).flops == want


def test_traffic_is_slice_aware():
    x = _t(100, 8)
    idx = torch.empty((10,), dtype=torch.long, device=META)
    vals = _t(10, 8)
    row = 10 * 8 * 4
    assert _count(lambda: x[idx]).traffic_bytes == 2 * row
    assert _count(lambda: x.index_put_((idx,), vals)).traffic_bytes == 2 * row
    assert _count(lambda: x.gather(0, idx[:, None].expand(10, 8))
                  ).traffic_bytes == 2 * row
    assert _count(lambda: x[:10].copy_(vals)).traffic_bytes == 2 * row
    assert _count(lambda: x.view(800)[3:]).traffic_bytes == 0
    assert _count(lambda: x + x).traffic_bytes == 3 * 100 * 8 * 4


def test_a_masked_selection_counts_every_element():
    """A mask's selection has no size on meta tensors: every element kept
    (the prefill write's page ids all inside the pool)."""
    x = _t(4, 5, 6)
    mask = torch.empty((4, 5), dtype=torch.bool, device=META)
    c = oa.OpCounter()
    with c:
        y = x[mask]
        x[mask] = y
    assert tuple(y.shape) == (20, 6)
    assert c.costs.traffic_bytes == 2 * 20 * 6 * 4 + 2 * 20 * 6 * 4


def test_temp_is_the_peak_of_live_intermediates():
    x = _t(256)                                  # 1 KiB, an argument

    def fn():
        a = x + 1
        b = a * 2
        del a
        c = b + 3
        del b, c
        d = x.view(16, 16)                       # a view: no bytes
        return d
    assert _count(fn).temp_bytes == 2 * 1024


def test_reads_leave_out_overwritten_destinations():
    x, y, z = _t(8), _t(8), _t(8)
    c = oa.OpCounter()
    with c:
        y.copy_(x)                               # y overwritten whole
        z[2:4] += 1                              # a view of z read
    assert c.read(x) and not c.read(y) and c.read(z)


def test_collectives_under_the_fake_group():
    """all_reduce and all_gather_into_tensor over a group of 2 in a fake
    world of 4: payload by kind (the gathered result's bytes), wire bytes
    by the ring factor of the group's size, the count."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group('fake', store=FakeStore(), rank=1, world_size=4)
    try:
        group = dist.new_group([0, 1])
        x, out = _t(4, 8), _t(8, 8)
        c = oa.OpCounter()
        with c:
            dist.all_reduce(x, group=group)
            dist.all_gather_into_tensor(out, x, group=group)
    finally:
        dist.destroy_process_group()
    costs = c.costs
    assert costs.coll_payload == {'all-reduce': 128.0, 'all-gather': 256.0}
    assert costs.coll_wire == 128 * 2 * 1 / 2 + 256 * 1 / 2
    assert costs.coll_count == 2


# ---------------------------------------------------------------------------
# Per-cell parity with the reference
# ---------------------------------------------------------------------------

def _check_flops(family, kind, mesh, rec):
    want = _reference(family, kind, mesh)[1]
    got = rec['flops_per_device']
    if family == 'hybrid':
        # the reference counts the shared block at every layer (docstring)
        assert got < want
        got = _record(family, kind, mesh,
                      hybrid_attn_every=1)['flops_per_device']
        if mesh and kind == 'prefill':
            got -= _replicated_cb_flops(family, kind)
        assert abs(got / want - 1) <= HYBRID_TOL, (got, want)
        return
    assert abs(got / want - 1) <= FLOP_TOL[kind], (got, want)


def _replicated_cb_flops(family, kind):
    """The FLOPs of the chunked SSD's C B^T that a zamba2 prefill rank on
    the mesh computes beyond GSPMD's share (docstring): (c x c) a chunk
    and row over all N, each layer, of which GSPMD computes 1/model."""
    from repro_torch.models.zamba2 import SSD_CHUNK

    _, tcfg, _, shape = _cell(family, kind, True)
    n_data, n_model = MESH[0]
    t = -(-shape.seq_len // SSD_CHUNK) * SSD_CHUNK
    per_layer = (2 * (shape.global_batch // n_data) * t * SSD_CHUNK
                 * tcfg.ssm_state)
    return tcfg.n_layers * per_layer * (n_model - 1) / n_model


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('family', list(FAMILIES))
def test_meshless_cell_matches_the_reference(family, kind):
    rec = _record(family, kind, False)
    assert rec['hbm']['argument'] == _reference(family, kind, False)[0]
    assert rec['arguments'] == rec['reference_arguments']
    assert rec['chips'] == 1 and rec['collectives']['n_collectives'] == 0
    _check_flops(family, kind, False, rec)


MESH_CELLS = [(f, 'train') for f in FAMILIES] + [
    (f, k) for f in ('dense', 'moe', 'ssm', 'hybrid', 'encdec')
    for k in ('prefill', 'decode')]
# the trainer under two serving variants' placement
VARIANT_TRAIN_CELLS = [(f, 'train', v) for f in ('dense', 'ssm', 'hybrid')
                       for v in ('serve_dh', 'serve_kv_dp')]


@pytest.mark.parametrize('family,kind', MESH_CELLS)
def test_mesh_cell_matches_the_reference(family, kind):
    rec = _record(family, kind, True)
    assert sum(rec['reference_arguments'].values()) == \
        _reference(family, kind, True)[0]
    _check_arguments(rec)
    # the port's blocks are the reference's, a train rank's batch too
    # (TRAIN_RULES split its sequence over ``model``)
    assert 'placement' not in rec, rec['placement']
    assert rec['chips'] == 4 and rec['collectives']['n_collectives'] > 0
    _check_flops(family, kind, True, rec)


@pytest.mark.parametrize('family,kind,variant', VARIANT_TRAIN_CELLS)
def test_variant_train_cell_matches_the_reference(family, kind, variant):
    """A train cell under ``serve_dh`` or ``serve_kv_dp`` on (2, 2): its
    argument bytes under the reference's specs of those rules equal the
    reference's compiled ``make_train_step(rules=)``'s, and the rank's own
    blocks hold those specs' bytes (the rules split no sequence; zamba2's
    packed leaves hold as many bytes as the specs' blocks)."""
    _, tcfg, _, shape = _cell(family, kind, True)
    rec = dryrun.cell_record(tcfg, shape, MESH, rules_variant=variant)
    assert rec['status'] == 'ok', rec
    if len(jax.devices()) < 4:
        pytest.skip(f'need 4 virtual devices, have {len(jax.devices())}')
    assert sum(rec['reference_arguments'].values()) == \
        _references(True)[family, kind, variant].result()[0]
    _check_arguments(rec)
    assert 'placement' not in rec, rec['placement']
    assert rec['chips'] == 4 and rec['collectives']['n_collectives'] > 0


# ---------------------------------------------------------------------------
# Production cells, shape-only
# ---------------------------------------------------------------------------

def _check_arguments(rec):
    """``hbm.argument`` is the rank's own blocks (``arguments``); a record
    says ``placement`` exactly where they differ from the reference's
    specs (``reference_arguments``)."""
    assert rec['hbm']['argument'] == sum(rec['arguments'].values())
    assert set(rec['arguments']) == set(rec['reference_arguments'])
    assert ('placement' in rec) == \
        (rec['arguments'] != rec['reference_arguments']), rec


def _production_check(rec, family, floor=None):
    """The record's keys and sums; a train or prefill cell's FLOPs on
    every chip at least 0.95 of ``floor`` (``model_flops`` by default)."""
    assert set(rec) >= {'arch', 'shape', 'mesh', 'status'}, rec
    assert rec['status'] == 'ok', rec
    assert set(rec) >= RECORD_KEYS and set(rec['hbm']) == HBM_KEYS, rec
    hbm = rec['hbm']
    assert hbm['peak'] == (hbm['argument'] + hbm['output'] + hbm['temp']
                           - hbm['alias'])
    _check_arguments(rec)
    assert rec['roofline']['dominant'] in ('compute', 'memory', 'collective')
    if rec['kind'] != 'decode':
        assert rec['flops_per_device'] * rec['chips'] >= \
            0.95 * (rec['model_flops'] if floor is None else floor), rec


def _layer_flops(arch, shape):
    """2 x the layer stack's parameters (the model's template) x the
    shape's tokens: rwkv6-3b's ``model_flops`` counts the config's
    3.61e9 parameters where its template holds 3.07e9, so a prefill rank
    that replicates no product counts 0.795 of it."""
    from repro_torch.models.api import build_model

    layers = build_model(get_config(arch)).param_shapes()['layers']
    shp = SHAPES[shape]
    return 2.0 * sum(int(np.prod(s)) for s in layers.values()) \
        * shp.global_batch * shp.seq_len


@pytest.mark.parametrize('shape', ['decode_32k', 'train_4k'])
@pytest.mark.parametrize('family', list(FAMILIES))
def test_production_cell(family, shape):
    rec = dryrun.run_cell(FAMILIES[family], shape, 'single')
    _production_check(rec, family)
    if rec['status'] == 'ok':
        assert rec['chips'] == 256


def test_argument_bytes_are_the_rank_s_own_blocks():
    """zamba2-2.7b x long_500k under ``serve_dh`` on (16, 16): no batch
    axis divides the one row, and the rank holds the reference's blocks
    of its caches (the batch axes moved onto the long KV's heads and the
    Mamba states).  ``hbm.argument`` (and so ``peak``, which ``check_fits``
    reads before a measured run) counts the rank's own blocks -- the same
    sum built here from the plan's blocks -- which are the reference's
    specs' bytes: the record names no ``placement``, and a card smaller
    than the count is refused."""
    from repro_torch.distributed.sharding import RULE_VARIANTS
    from repro_torch.distributed.tp import StepParallel
    from repro_torch.launch.mesh import describe
    from repro_torch.models.api import build_model

    cfg, shp = get_config('zamba2-2.7b'), SHAPES['long_500k']
    rec = dryrun.run_cell('zamba2-2.7b', 'long_500k', 'single',
                          rules_variant='serve_dh')
    _production_check(rec, 'hybrid')
    desc = describe(*dryrun.layout_of('single'))
    plan = StepParallel(cfg, desc, desc.coords(rec['rank']),
                        batch=shp.global_batch, seq_len=shp.seq_len,
                        rules=RULE_VARIANTS['serve_dh'])
    assert plan.moved
    model = build_model(cfg)

    def nbytes(tmpl, block):
        return sum(int(np.prod(block(p, leaf.shape).local_shape))
                   * leaf.dtype.itemsize
                   for p, leaf in dryrun._template_leaves(tmpl))

    assert rec['arguments']['params'] == nbytes(model.template(), plan.block)
    assert rec['arguments']['cache'] == nbytes(model.cache_template(shp),
                                               plan.cache_block)
    assert rec['arguments'] == rec['reference_arguments']
    assert 'placement' not in rec, rec['placement']
    with pytest.raises(MemoryError):
        dryrun.check_fits(rec['hbm']['peak'], rec['hbm']['argument'] // 2,
                          'a small card')


def test_multi_pod_cell():
    rec = dryrun.run_cell('qwen3-0.6b', 'prefill_32k', 'multi')
    _production_check(rec, 'dense')
    assert rec['chips'] == 512


def test_not_ported_cells_are_the_listed_set():
    """Over the sweep's cells, under the default rules and under every
    rule variant, no cell is refused but by ``cell_supported``'s skip:
    every family serves and trains on a mesh, long_500k too, under every
    placement of ``RULE_VARIANTS``."""
    for arch, shape, mk in dryrun.all_cells():
        cfg, shp = get_config(arch), SHAPES[shape]
        ok, why = cell_supported(cfg, shp)
        want = None if ok else {'status': why}
        for variant in J_RULE_VARIANTS:
            assert dryrun.refusal(cfg, shp, dryrun.layout_of(mk),
                                  variant) == want, (arch, shape, variant)
        assert dryrun.refusal(cfg, shp, dryrun.layout_of(mk)) == want
    assert dryrun.ARCHS == tuple(J_ARCHS)
    assert set(SHAPES) == set(J_SHAPES)


@pytest.mark.parametrize('variant', sorted(J_RULE_VARIANTS))
def test_rule_variants_the_port_refuses(variant):
    """None: every kind counts on a mesh under every rule variant (the
    trainer and the serve step place the weights by each), and a rule set
    whose placement is none of them raises."""
    cfg = reduced(get_config('qwen3-0.6b'))
    for kind in KINDS:
        shape = ShapeConfig('c', 64, 4, kind)
        assert dryrun.refusal(cfg, shape, MESH, variant) is None, kind
    odd = dict(J_RULE_VARIANTS[variant] or {}, embed='model')
    with pytest.raises(NotImplementedError):
        ts.check_train_rules(odd)
    with pytest.raises(NotImplementedError):
        ts.check_serve_mesh(None, None, None, odd)


VARIANT_CACHE_GB = {    # the reference's cache bytes a rank, decode_32k
    'qwen3-0.6b': {'serve_kv_dp': 30.300, 'serve_seq': 1.894,
                   'serve_dh': 1.894},
    'zamba2-2.7b': {'serve_kv_dp': 49.263, 'serve_seq': 3.080,
                    'serve_dh': 3.623},
    'seamless-m4t-medium': {'serve_kv_dp': 3.234, 'serve_seq': 0.202,
                            'serve_dh': 0.202}}


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('arch', list(VARIANT_CACHE_GB))
def test_rule_variant_cells(arch, variant, capsys):
    """``--rules serve_*`` on (16, 16): an ``ok`` record whose rank holds
    the reference's cache blocks; params differ only in the leaves that
    ``placement`` names (seamless's vocabulary as by default; qwen3's 8
    kv-heads, which 16 does not divide, are the reference's blocks of the
    flattened q/k/v width, and under serve_dh the q/k norms are the
    reference's head_dim blocks, so qwen3's params do not differ).  serve_dh moves no
    K/V block: its all-gathers are P V's head_dim blocks, B_r x H x Dh
    a layer, and the q/k norms' blocks gathered whole, 2 x Dh a layer;
    serve_kv_dp holds the pool whole."""
    dryrun.main(['--arch', arch, '--shape', 'decode_32k', '--mesh',
                 'single', '--rules', variant])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _production_check(rec, get_config(arch).family)
    args, ref = rec['arguments'], rec['reference_arguments']
    assert args['cache'] == ref['cache']
    assert round(ref['cache'] / 1e9, 3) == VARIANT_CACHE_GB[arch][variant]
    assert 'cache' not in rec.get('placement', {})
    kinds = rec['collectives']['bytes_by_kind']
    if variant == 'serve_dh' and arch == 'qwen3-0.6b':
        cfg = get_config(arch)
        rows = SHAPES['decode_32k'].global_batch // 16
        out = rows * cfg.n_heads * cfg.hd * 4 * cfg.n_layers
        norms = 2 * cfg.hd * cm.DEFAULT_DTYPE.itemsize * cfg.n_layers
        assert kinds['all-gather'] == out + norms, kinds
    if arch == 'qwen3-0.6b':
        assert 'params' not in rec.get('placement', {}), rec['placement']


# the architectures whose heads ``model`` = 16 does not divide (40 q-heads,
# or 8 kv-heads): the port holds the reference's head_dim placement
HEAD_DIM_ARCHS = ('qwen3-14b', 'llama4-scout-17b-a16e', 'command-r-35b',
                  'phi3.5-moe-42b-a6.6b', 'llava-next-mistral-7b',
                  'qwen3-0.6b', 'internlm2-1.8b')
# ... rwkv6-3b's 40 wkv heads (a block of every head's value channels) and
# seamless-m4t-medium's vocabulary of 256206 (the embedding and the head
# on d_model)
WKV_VOCAB_ARCHS = ('rwkv6-3b', 'seamless-m4t-medium')
HEAD_DIM_GB = {    # a rank's arguments under the reference's specs
    ('qwen3-14b', 'decode_32k'): 4.552,
    ('llama4-scout-17b-a16e', 'decode_32k'): 16.719,
    ('rwkv6-3b', 'decode_32k'): 0.408,
    ('seamless-m4t-medium', 'decode_32k'): 0.296}
# the cells whose serve placement still departs under a rule variant:
# none (long_500k's one row is placed as the reference's specs place it)
DEPARTING: dict = {}
PLACEMENT_CELLS = [(a, s) for a in HEAD_DIM_ARCHS + WKV_VOCAB_ARCHS
                   for s in ('decode_32k', 'prefill_32k', 'train_4k')] + [
    ('rwkv6-3b', 'long_500k'), ('zamba2-2.7b', 'long_500k')]
# a rank's arguments at long_500k under each variant, on (16, 16), in
# GB rounded to 3 places (zamba2: 4,900,097,640 / 685,493,340 /
# 6,351,975,240 B; rwkv6: 2,755,660,804 / 395,136,004 / 396,518,404 B)
LONG_GB = {'zamba2-2.7b': {'serve_dh': 4.900, 'serve_seq': 0.685,
                           'serve_kv_dp': 6.352},
           'rwkv6-3b': {'serve_dh': 2.756, 'serve_seq': 0.395,
                        'serve_kv_dp': 0.397}}


@pytest.mark.parametrize('arch,shape', PLACEMENT_CELLS)
def test_head_dim_placement_cells(arch, shape):
    """On (16, 16), where ``model`` does not divide the attention heads,
    rwkv6's wkv heads or the vocabulary, and at long_500k, where no batch
    axis divides the one row: a serve cell's rank holds the reference's
    blocks leaf for leaf (no ``placement``), under the default rules and,
    for decode_32k, under ``serve_seq`` and ``serve_kv_dp`` too (and
    ``serve_dh`` for rwkv6-3b and seamless-m4t-medium), for long_500k
    under every variant (:data:`LONG_GB`: zamba2-2.7b's serve_kv_dp rank
    reads 6.352 GB, where it held the one row's long KV whole over the
    batch axes at 97.015); a train cell's rank holds its rows' block of
    the sequence (``TRAIN_RULES`` split it over ``model``): no
    ``placement`` either."""
    variants = ('default',)
    if shape == 'decode_32k':
        variants += ('serve_seq', 'serve_kv_dp') + (
            ('serve_dh',) if arch in WKV_VOCAB_ARCHS else ())
    elif shape == 'long_500k':
        variants += tuple(LONG_GB[arch])
    floor = _layer_flops(arch, shape) if (arch, shape) == (
        'rwkv6-3b', 'prefill_32k') else None
    for variant in variants:
        rec = dryrun.run_cell(arch, shape, 'single', rules_variant=variant)
        _production_check(rec, get_config(arch).family, floor)
        departs = DEPARTING.get((arch, shape, variant))
        if departs is not None:
            assert {g: set(v) for g, v in rec['placement'].items()} == \
                departs, rec['placement']
            continue
        assert 'placement' not in rec, rec['placement']
        assert rec['arguments'] == rec['reference_arguments']
        gb = (LONG_GB[arch].get(variant) if shape == 'long_500k'
              else HEAD_DIM_GB.get((arch, shape)))
        if gb is not None and (shape == 'long_500k'
                               or variant in ('default', 'serve_seq')):
            assert round(rec['hbm']['argument'] / 1e9, 3) == gb
        if (arch, shape) == ('qwen3-0.6b', 'train_4k'):
            # tokens and labels: 16 rows of 256 of the 4096 positions
            assert rec['arguments']['batch'] == 32768


def test_cli_prints_a_record(capsys):
    dryrun.main(['--arch', 'qwen3-0.6b', '--shape', 'decode_32k', '--mesh',
                 'single'])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _production_check(rec, 'dense')


def test_sweep_writes_a_line_a_cell(tmp_path, monkeypatch):
    """``--sweep`` writes one JSON line a cell (here the not-counted cells
    of a one-architecture sweep, each a skip status) and on
    a rerun skips the cells already written."""
    monkeypatch.setattr(dryrun, 'ARCHS', ('rwkv6-3b',))
    monkeypatch.setattr(dryrun, 'run_cell', lambda arch, shape, mk: dict(
        arch=arch, shape=shape, mesh=mk, **(dryrun.refusal(
            get_config(arch), SHAPES[shape], dryrun.layout_of(mk)) or
            {'status': 'ok'})))
    out = tmp_path / 'sweep.jsonl'
    dryrun.main(['--sweep', '--out', str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(r['arch'], r['shape'], r['mesh']) for r in lines] == \
        list(dryrun.all_cells())
    dryrun.main(['--sweep', '--out', str(out)])
    assert len(out.read_text().splitlines()) == len(lines)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('mesh', [False, True], ids=['meshless', 'mesh'])
def test_measure_on_the_cpu(mesh, kind):
    """``measure`` runs the step on the CPU only when asked -- meshless, or
    the counted rank's over its blocks beside the fake group -- and
    records the host clock's median (no device peak there); the default
    process group is gone afterwards."""
    rec = dryrun.cell_record(reduced(get_config('phi3.5-moe-42b-a6.6b'),
                                     n_experts=16),
                             ShapeConfig('c', 64, 4, kind),
                             MESH if mesh else None, measure=True,
                             device='cpu')
    m = rec['measured']
    assert m['device'] == 'cpu' and m['step_ms'] > 0
    assert m['peak_bytes'] is None and len(m['step_ms_all']) == m['reps']
    assert m['collectives'] == ('not run' if mesh else None)
    assert not dist.is_initialized()


def test_measure_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        dryrun.cell_record(reduced(get_config('qwen3-0.6b')),
                           ShapeConfig('c', 64, 2, 'decode'), None,
                           measure=True)


def test_a_cell_past_the_card_s_memory_raises_before_allocating():
    """``measure`` on the card first holds the record's counted peak
    against the card's memory: a cell past it raises MemoryError, one
    inside it passes."""
    card = 80 * 2 ** 30
    with pytest.raises(MemoryError, match='counted peak'):
        dryrun.check_fits(card + 1, card, 'the card')
    dryrun.check_fits(card, card, 'the card')
