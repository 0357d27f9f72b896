"""The dry-run's per-cell cost report, the port's counterpart of the
reference's ``launch/dryrun.py``: for each (arch x shape x mesh) cell, one
rank's train or serve step counted without running it, and the roofline
terms that follow on one H100 (``launch/mesh.py``'s constants).

The reference lowers and compiles each cell over 512 virtual devices and
reads the compiler's memory analysis and HLO.  Here no compiler sees the
whole program, so:

- ``hbm.argument`` is exact: the bytes of the rank's own blocks of the
  step's arguments that the step reads -- params (with the ZeRO-1
  optimizer state for train), cache and batch -- by group in
  ``arguments``.  ``reference_arguments`` are the same under the
  reference's specs, which is what the reference's compiled program holds
  (``argument_size_in_bytes``).  The two agree wherever the port's
  placement is the reference's -- every cell of the sweep -- and where
  they would not, the record names each leaf whose bytes differ, by
  group, with both counts (``placement``).  ``output`` is what the step returns (the cache, or
  params and optimizer state, updated in place and counted as ``alias``,
  and the scores or the metrics);
- FLOPs, traffic, collectives and ``temp`` come from running one rank's
  step shape-only (``launch/op_analysis.py``): on ``meta`` tensors beside
  a fake process group of the mesh's size
  (``torch.testing._internal.distributed.fake_pg``), the rank's own blocks
  as meta tensors.  Every rank's blocks are the same size here; the
  record names the rank counted (``rank``);
- ``trace_s`` (the count's seconds) replaces ``lower_s`` / ``compile_s``;
  ``raw_cost_analysis`` is dropped (no compiler makes one).

Cells that ``cell_supported`` skips keep their skip status; every other
cell counts under every rule variant (``--rules serve_kv_dp | serve_seq |
serve_dh | train_no_sp``: ``training/train_step.py``'s ``make_serve_step``
and ``make_train_step(rules=)``).  ``--mesh none`` counts the meshless
step on one device (the reference has no such cell).  ``--measure`` also runs
the cell for real, on the card (it raises without one; the CPU only with
``--device cpu``): the meshless step, or the counted rank's step beside
the fake process group (its collectives move no data: the rank's compute
and memory alone), and adds its median step time (CUDA events) and peak
memory (``torch.cuda.max_memory_allocated``) to the record.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k --mesh single
    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k --mesh single --rules serve_kv_dp
    python -m repro_torch.launch.dryrun --sweep --out results/dryrun_torch.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import SHAPES, cell_supported, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import common as cm
from repro_torch.models.api import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from repro_torch.training import tree as tr

MEASURE_REPS = 5
Layout = Tuple[Tuple[int, ...], Tuple[str, ...]]

# the reference's ten assigned architectures, in its order
ARCHS = ('seamless-m4t-medium', 'internlm2-1.8b', 'command-r-35b',
         'qwen3-14b', 'qwen3-0.6b', 'rwkv6-3b', 'llava-next-mistral-7b',
         'phi3.5-moe-42b-a6.6b', 'llama4-scout-17b-a16e', 'zamba2-2.7b')


# ---------------------------------------------------------------------------
# Bytes of the step's arguments under their specs
# ---------------------------------------------------------------------------

def _block_bytes(shape, dtype, spec, mesh, coords) -> int:
    """Bytes of rank ``coords``'s block of a ``shape`` tensor under
    ``spec`` (the whole tensor meshless)."""
    if mesh is not None:
        shape = shd.local_bounds(shape, spec, mesh, coords).local_shape
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


def _template_leaves(tmpl):
    """[(path, PSpec)] of a template."""
    if isinstance(tmpl, cm.PSpec):
        return [((), tmpl)]
    return [((k,) + p, leaf) for k, v in tmpl.items()
            for p, leaf in _template_leaves(v)]


def _build(fn, tmpl, path=()):
    """``fn(path, leaf)`` over a template's leaves, nested like it."""
    if isinstance(tmpl, cm.PSpec):
        return fn(path, tmpl)
    return {k: _build(fn, v, path + (k,)) for k, v in tmpl.items()}


def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs.spec


def _tree_bytes(tmpl, specs, mesh, coords, used, group, leaves) -> int:
    total = 0
    for p, leaf in _template_leaves(tmpl):
        if used(group, p):
            n = _block_bytes(leaf.shape, leaf.dtype,
                             _spec_at(specs, p) if specs else None, mesh,
                             coords)
            leaves[(group, p)] = n
            total += n
    return total


def argument_bytes(model, shape: ShapeConfig, mesh, rules, *,
                   coords=None, zero1: bool = True,
                   used=lambda group, path: True,
                   leaves: Optional[Dict] = None) -> Dict[str, int]:
    """{'params', 'opt', 'cache', 'batch'}: the bytes of rank ``coords``'s
    blocks of a step's arguments under the reference's specs (meshless:
    the whole arguments), counting only the leaves ``used(group, path)``
    says the step reads (``group`` 'params', 'cache' or 'batch'); each
    such leaf's bytes go into ``leaves`` by (group, path).  ``opt``
    (train): the step counter and the f32 moments, with ZeRO-1 each
    moment's block cut over the data axes."""
    leaves = {} if leaves is None else leaves
    tmpl = model.template()
    ispecs = model.input_specs(shape)
    if shape.kind == 'train':
        rules = rules or shd.TRAIN_RULES
        pspec = ts.param_specs(model, mesh, rules) if mesh else None
        bspec = ts.batch_specs(model, shape, mesh, rules) if mesh else None
        ospec = (opt.opt_state_specs(pspec, mesh, zero1=zero1,
                                     param_shapes=model.param_shapes())
                 if mesh else None)
        moments = 2 * sum(
            _block_bytes(leaf.shape, torch.float32,
                         _spec_at(ospec['mu'], p) if mesh else None, mesh,
                         coords)
            for p, leaf in _template_leaves(tmpl))
        out = {'params': _tree_bytes(tmpl, pspec, mesh, coords, used,
                                     'params', leaves),
               'opt': 4 + moments, 'cache': 0}
    else:
        _, specs = ts.make_serve_step(model, mesh, shape, rules=rules) \
            if mesh else (None, None)
        pspec = specs['params'] if specs else None
        bspec = specs['batch'] if specs else None
        out = {'params': _tree_bytes(tmpl, pspec, mesh, coords, used,
                                     'params', leaves), 'opt': 0,
               'cache': _tree_bytes(model.cache_template(shape),
                                    specs['cache'] if specs else None, mesh,
                                    coords, used, 'cache', leaves)}
    for k, s in ispecs.items():
        if used('batch', (k,)):
            leaves[('batch', (k,))] = _block_bytes(
                s.shape, s.dtype, bspec[k].spec if bspec else None, mesh,
                coords)
    out['batch'] = sum(n for (g, _), n in leaves.items() if g == 'batch')
    return out


# ---------------------------------------------------------------------------
# One rank's step, shape-only
# ---------------------------------------------------------------------------

def _fake_world(n: int, rank: int):
    """A fake default process group of ``n`` ranks (collectives return at
    once, moving no data)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError('a process group is already initialized: count a '
                           'mesh cell in a process of its own')
    dist.init_process_group('fake', store=FakeStore(), rank=rank,
                            world_size=n)


def _rank_inputs(model, shape, step, device):
    """(params, cache or opt state, batch): the rank's blocks (``step.plan``
    says which; meshless, the whole arguments).  On meta tensors for the
    count; on a real device for a measurement: weights drawn as
    ``init_params(0)`` draws them (the same numbers meshless), zero caches
    and moments, the batch's rows of ``make_inputs``."""
    plan = getattr(step, 'plan', None)
    train = shape.kind == 'train'
    meta = device.type == 'meta'
    gen = None if meta else torch.Generator(device=device).manual_seed(0)

    def param(path, leaf):
        if plan is None:
            local = leaf.shape
        elif train:
            local = plan.param_blocks['/'.join(path)].local_shape
        else:
            local = plan.block(path, leaf.shape).local_shape
        leaf = dataclasses.replace(leaf, shape=tuple(local))
        t = (torch.empty(leaf.shape, dtype=leaf.dtype, device=device) if meta
             else cm.init_leaf(leaf, gen, device))
        return t.requires_grad_() if train else t

    params = _build(param, model.template())
    specs = model.input_specs(shape)
    b = shape.global_batch
    rows = np.arange(b)
    if plan is not None:
        rows = (ts.batch_rows(b, plan) if train
                else rows[plan.rows])
    if meta:
        batch = {k: torch.empty(
            (len(rows),) + (plan.batch_block(k, v.shape).local_shape[1:]
                            if train and plan is not None
                            else tuple(v.shape[1:])),
            dtype=v.dtype, device=device) for k, v in specs.items()}
    else:
        full = model.make_inputs(shape.kind, b, shape.seq_len,
                                 np.random.default_rng(0), device=device)
        full = {k: full[k] for k in specs}
        batch = (ts.shard_batch(full, plan) if train and plan is not None
                 else {k: v[torch.as_tensor(rows, device=device)]
                       for k, v in full.items()})
    if train:
        state = (plan.init_opt_state() if plan is not None
                 else opt.init_opt_state(params))
        return params, state, batch
    cache = _build(lambda p, leaf: torch.zeros(
        plan.cache_block(p, leaf.shape).local_shape if plan else leaf.shape,
        dtype=leaf.dtype, device=device), model.cache_template(shape))
    return params, cache, batch


@contextlib.contextmanager
def rank_step(model, shape: ShapeConfig, layout: Optional[Layout], device,
              *, rank: int = 0, rules=None, microbatches: int = 1,
              zero1: bool = True):
    """(rank ``rank``'s step on a mesh of ``layout``, its arguments) on
    ``device`` while inside: the step of a meshless cell, or one rank's
    beside a fake process group of the mesh's size (its collectives move
    no data), which is destroyed on the way out."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = None
    if layout is not None:
        _fake_world(int(np.prod(layout[0])), rank)
    try:
        if layout is not None:
            dm = init_device_mesh('cpu', layout[0], mesh_dim_names=layout[1])
            ranks = np.asarray(dm.mesh.tolist()).reshape(layout[0])
            mesh = meshlib.Mesh(ranks, layout[1], rank=rank, device=device,
                                device_mesh=dm)
        if shape.kind == 'train':
            step = ts.make_train_step(model, mesh, microbatches=microbatches,
                                      zero1=zero1, rules=rules)
        else:
            step, _ = ts.make_serve_step(model, mesh, shape, rules=rules)
        yield step, _rank_inputs(model, shape, step, device)
    finally:
        if layout is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _call(step, shape, args):
    if shape.kind == 'train':
        return step(*args)
    with torch.no_grad():
        return step(*args)


def count_step(model, shape: ShapeConfig, layout: Optional[Layout], *,
               rank: int = 0, rules=None, microbatches: int = 1,
               zero1: bool = True):
    """(ModuleCosts, ``used(group, path)``: whether the step read that
    argument leaf, ``held``: the bytes of the rank's own argument blocks
    that it read, by group as :func:`argument_bytes` gives them, the same
    by (group, path) of each leaf read, seconds) of rank ``rank``'s step on
    a mesh of ``layout`` (meshless: None), run shape-only on meta
    tensors."""
    t0 = time.perf_counter()
    with rank_step(model, shape, layout, torch.device('meta'), rank=rank,
                   rules=rules, microbatches=microbatches,
                   zero1=zero1) as (step, args):
        with OpCounter() as counter:
            _call(step, shape, args)
        groups = dict(zip(('params', 'cache', 'batch'), args))
        read = {(g, p): counter.read(t) for g, tree in groups.items()
                for p, t in _tree_leaves(tree)}
        leaves = {(g, p): t.numel() * t.element_size()
                  for g, tree in groups.items()
                  for p, t in _tree_leaves(tree)
                  if shape.kind == 'train' and g == 'cache' or read[(g, p)]}
        held = {g: sum(n for (h, _), n in leaves.items() if h == g)
                for g in groups}
    if shape.kind == 'train':        # the second argument is AdamW's state
        held['opt'], held['cache'] = held['cache'], 0
    else:
        held['opt'] = 0
    return (counter.costs, lambda group, path: read.get((group, path), True),
            held, leaves, time.perf_counter() - t0)


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _tree_leaves(v, path + (k,))]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _serve_rules(shape: ShapeConfig, rules):
    return rules or (shd.LONG_SERVE_RULES if shape.name == 'long_500k'
                     else shd.SERVE_RULES)


def refusal(cfg: ModelConfig, shape: ShapeConfig, layout: Optional[Layout],
            rules_variant: str = 'default') -> Optional[Dict[str, str]]:
    """The status of a cell that is not counted, or None: the skip of
    ``cell_supported``.  Every other cell counts, on a mesh under every
    rule variant: a rule set the port's plans cannot place raises
    (``train_step.check_train_rules``, ``check_serve_mesh``)."""
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {'status': why}
    if layout is None:
        return None
    rules = shd.RULE_VARIANTS.get(rules_variant)
    if shape.kind == 'train':
        ts.check_train_rules(rules or shd.TRAIN_RULES)
    else:
        ts.check_serve_mesh(build_model(cfg), meshlib.describe(*layout),
                            shape, _serve_rules(shape, rules))
    return None


def _plan(cfg, shape: ShapeConfig, desc, coords, rules):
    """Rank ``coords``'s placement under ``rules``: a serve step's plan,
    or the trainer's (``TRAIN_RULES`` where None)."""
    from repro_torch.distributed.tp import StepParallel, TensorParallel

    if shape.kind == 'train':
        return TensorParallel(cfg, desc, coords, rules=rules)
    return StepParallel(cfg, desc, coords, batch=shape.global_batch,
                        seq_len=shape.seq_len, rules=_serve_rules(shape,
                                                                  rules))


def _largest_rank(model, layout: Layout, shape: ShapeConfig,
                  rules) -> Tuple[int, Dict[str, int]]:
    """The rank whose weight blocks are largest under the port's placement
    (the lowest of equals), and its coordinates; the batch axes' blocks
    are even, so one rank of each ``model`` coordinate is looked at."""
    desc = meshlib.describe(*layout)
    shapes = tr.leaves_with_paths(model.param_shapes())
    best = None
    for r in range(desc.shape.get('model', 1)):
        coords = desc.coords(r)
        plan = _plan(model.cfg, shape, desc, coords, rules)
        n = sum(int(np.prod(plan.block(p, s).local_shape)) for p, s in shapes)
        if best is None or n > best[0]:
            best = (n, r, coords)
    return best[1], best[2]


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N T for train, 2 N T for prefill, 2 N B for a decode step (N the
    active parameters; the reference's)."""
    if shape.kind == 'train':
        return 6 * cfg.active_param_count() * shape.global_batch \
            * shape.seq_len
    tokens = shape.global_batch * (shape.seq_len if shape.kind == 'prefill'
                                   else 1)
    return 2 * cfg.active_param_count() * tokens


def output_bytes(shape: ShapeConfig, args: Dict[str, int],
                 scores_rows: int, vocab_block: int) -> Tuple[int, int]:
    """(output, alias): what the step returns and, of it, what it updates
    in place (the reference donates the same buffers)."""
    if shape.kind == 'train':
        alias = args['params'] + args['opt']
        return alias + 3 * 4, alias
    return args['cache'] + scores_rows * vocab_block * 4, args['cache']


def cell_record(cfg: ModelConfig, shape: ShapeConfig,
                layout: Optional[Layout], *, microbatches: int = 1,
                zero1: bool = True, rules_variant: str = 'default',
                measure: bool = False, device=None,
                names: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """The record of one cell: ``cfg`` at ``shape`` on a mesh of ``layout``
    ((shape, axis names); None: meshless)."""
    rec: Dict[str, Any] = dict(names or {}, kind=shape.kind,
                               microbatches=microbatches,
                               rules_variant=rules_variant)
    skipped = refusal(cfg, shape, layout, rules_variant)
    if skipped is not None:
        rec.update(skipped)
        return rec
    model = build_model(cfg)
    rules = shd.RULE_VARIANTS.get(rules_variant)
    serve_rules = _serve_rules(shape, rules)
    rank, coords, desc = 0, None, None
    if layout is not None:
        desc = meshlib.describe(*layout)
        rank, coords = _largest_rank(model, layout, shape, rules)
    try:
        costs, used, held, held_leaves, trace_s = count_step(
            model, shape, layout, rank=rank, rules=rules,
            microbatches=microbatches, zero1=zero1)
    except Exception as e:  # a failure here is a bug in the port's step
        rec.update(status='FAILED', error=f'{type(e).__name__}: {e}')
        return rec
    ref_leaves: Dict = {}
    reference = argument_bytes(model, shape, desc,
                               rules if shape.kind == 'train' else serve_rules,
                               coords=coords, zero1=zero1, used=used,
                               leaves=ref_leaves)
    args = {g: held[g] for g in reference}
    rows, vocab = shape.global_batch, cfg.vocab_size
    if layout is not None and shape.kind != 'train':
        plan = _plan(cfg, shape, desc, coords, rules)
        rows = plan.rows.stop - plan.rows.start
        vocab = plan.vocab[1] - plan.vocab[0]
    out, alias = output_bytes(shape, args, rows, vocab)
    argument = sum(args.values())
    hbm = {'argument': argument, 'output': out, 'temp': costs.temp_bytes,
           'alias': alias,
           'peak': argument + out + costs.temp_bytes - alias}
    chips = int(np.prod(layout[0])) if layout is not None else 1
    t_comp = costs.flops / meshlib.PEAK_FLOPS_BF16
    t_mem = costs.traffic_bytes / meshlib.HBM_BW
    t_coll = costs.coll_wire / meshlib.NVLINK_BW
    mflops = model_flops(cfg, shape)
    rec.update(
        status='ok', chips=chips, rank=rank, trace_s=trace_s,
        flops_per_device=costs.flops, bytes_per_device=costs.traffic_bytes,
        hbm=hbm, arguments=args, reference_arguments=reference,
        collectives={'bytes_by_kind': costs.coll_payload,
                     'wire_bytes': costs.coll_wire,
                     'n_collectives': costs.coll_count},
        roofline={'compute_s': t_comp, 'memory_s': t_mem,
                  'collective_s': t_coll,
                  'dominant': max((('compute', t_comp), ('memory', t_mem),
                                   ('collective', t_coll)),
                                  key=lambda kv: kv[1])[0]},
        model_flops=mflops,
        useful_flops_ratio=(mflops / (costs.flops * chips)
                            if costs.flops else 0.0))
    if args != reference:
        rec['placement'] = placement_diff(args, reference, held_leaves,
                                          ref_leaves)
    if measure:
        rec['measured'] = measure_cell(model, shape, layout, device=device,
                                       rank=rank, rules=rules,
                                       microbatches=microbatches, zero1=zero1,
                                       need_bytes=hbm['peak'])
    return rec


def placement_diff(args, reference, leaves, ref_leaves) -> Dict[str, Any]:
    """Where the rank's blocks differ from the reference's specs: {group:
    {leaf path: {'port': bytes, 'reference': bytes}}} of every leaf whose
    bytes differ (``opt``, the optimizer state's total: {'port',
    'reference'})."""
    out: Dict[str, Any] = {}
    for (group, path), n in sorted(leaves.items()):
        want = ref_leaves.get((group, path))
        if want is not None and want != n:
            out.setdefault(group, {})['/'.join(path)] = {'port': n,
                                                         'reference': want}
    if args.get('opt') != reference.get('opt'):
        out['opt'] = {'port': args['opt'], 'reference': reference['opt']}
    return out


def check_fits(need_bytes: int, total_bytes: int, where: str) -> None:
    """Raise before a measured run allocates anything when the counted
    peak (argument + output + temp - alias) passes the device's memory."""
    if need_bytes > total_bytes:
        raise MemoryError(
            f'the cell needs {need_bytes / 1e9:.2f} GB (counted peak), '
            f'{where} holds {total_bytes / 1e9:.2f} GB: measure a cell that '
            'fits (a mesh cell runs one rank\'s blocks)')


def measure_cell(model, shape: ShapeConfig, layout: Optional[Layout] = None,
                 *, device=None, rank: int = 0, rules=None,
                 microbatches: int = 1, zero1: bool = True,
                 reps: int = MEASURE_REPS,
                 need_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Run the step of ``shape`` for real on ``device`` (the card unless
    ``device='cpu'``; weights drawn as ``init_params(0)`` draws them, bf16):
    meshless, or rank ``rank``'s step of a mesh of ``layout`` beside a fake
    process group (its collectives move no data, so the time is the rank's
    compute and memory alone).  The median of ``reps`` steps after one
    warm-up (CUDA events on the card, the host clock on the CPU) and the
    peak memory over them, the arguments included
    (``torch.cuda.max_memory_allocated``; not measured on the CPU).  With
    ``need_bytes`` (the record's ``hbm.peak``), a card whose memory is
    smaller raises before anything is allocated."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == 'cuda'
    if cuda and need_bytes is not None:
        check_fits(need_bytes, torch.cuda.get_device_properties(dev)
                   .total_memory, torch.cuda.get_device_name(dev))
    times = []
    with rank_step(model, shape, layout, dev, rank=rank, rules=rules,
                   microbatches=microbatches, zero1=zero1) as (step, args):
        _call(step, shape, args)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(reps):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _call(step, shape, args)
                end.record()
                torch.cuda.synchronize(dev)
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                _call(step, shape, args)
                times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        del args
    return {'device': (torch.cuda.get_device_name(dev) if cuda else 'cpu'),
            'step_ms': float(np.median(times)), 'step_ms_all': times,
            'peak_bytes': peak, 'reps': reps,
            'collectives': 'not run' if layout is not None else None}


MESH_KINDS = ('single', 'multi', 'none')


def layout_of(mesh_kind: str) -> Optional[Layout]:
    """The production layout of ``mesh_kind`` (None: meshless)."""
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f'mesh {mesh_kind!r}: one of {MESH_KINDS}')
    if mesh_kind == 'none':
        return None
    return meshlib.production_layout(multi_pod=mesh_kind == 'multi')


def run_cell(arch: str, shape: Union[str, ShapeConfig], mesh_kind: str, *,
             microbatches: int = 1, zero1: bool = True,
             rules_variant: str = 'default', measure: bool = False,
             device=None) -> Dict[str, Any]:
    """The record of (``arch`` x ``shape`` x ``mesh_kind``): ``shape`` a
    name of ``SHAPES`` or a ``ShapeConfig``; ``mesh_kind`` 'single' (data
    16 x model 16), 'multi' (pod 2 x data 16 x model 16) or 'none'."""
    shape_cfg = SHAPES[shape] if isinstance(shape, str) else shape
    return cell_record(get_config(arch), shape_cfg, layout_of(mesh_kind),
                       microbatches=microbatches, zero1=zero1,
                       rules_variant=rules_variant, measure=measure,
                       device=device,
                       names={'arch': arch, 'shape': shape_cfg.name,
                              'mesh': mesh_kind})


# ---------------------------------------------------------------------------
# Sweep orchestration
# ---------------------------------------------------------------------------

def all_cells(meshes: Sequence[str] = ('single', 'multi')):
    for arch in ARCHS:
        for shape in SHAPES:
            for mk in meshes:
                yield arch, shape, mk


def sweep(out_path: str, *, use_subprocess: bool,
          meshes: Sequence[str] = ('single', 'multi'),
          only_missing: bool = True) -> None:
    """One JSON line a cell into ``out_path`` (cells already there with a
    status other than FAILED are skipped)."""
    done = set()
    if only_missing and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get('status') not in (None, 'FAILED'):
                    done.add((r['arch'], r['shape'], r['mesh']))
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    cells = [c for c in all_cells(meshes) if c not in done]
    print(f'[dryrun] {len(cells)} cells to run ({len(done)} cached)',
          flush=True)
    with open(out_path, 'a') as f:
        for i, (arch, shape, mk) in enumerate(cells):
            t0 = time.time()
            if use_subprocess:
                proc = subprocess.run(
                    [sys.executable, '-m', 'repro_torch.launch.dryrun',
                     '--arch', arch, '--shape', shape, '--mesh', mk],
                    capture_output=True, text=True)
                try:
                    rec = json.loads(proc.stdout.strip().splitlines()[-1])
                except (IndexError, json.JSONDecodeError):
                    rec = {'arch': arch, 'shape': shape, 'mesh': mk,
                           'status': 'FAILED',
                           'error': (proc.stderr or proc.stdout)[-2000:]}
            else:
                rec = run_cell(arch, shape, mk)
            f.write(json.dumps(rec) + '\n')
            f.flush()
            print(f'[dryrun {i + 1}/{len(cells)}] {arch} x {shape} x {mk}: '
                  f'{rec.get("status")} ({time.time() - t0:.1f}s)',
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--arch', default=None)
    ap.add_argument('--shape', default=None)
    ap.add_argument('--mesh', default='single', choices=MESH_KINDS)
    ap.add_argument('--sweep', action='store_true')
    ap.add_argument('--subprocess', action='store_true')
    ap.add_argument('--microbatches', type=int, default=1)
    ap.add_argument('--no-zero1', action='store_true')
    ap.add_argument('--rules', default='default',
                    help='sharding-rule variant (see RULE_VARIANTS)')
    ap.add_argument('--measure', action='store_true',
                    help="also run the cell (a mesh cell: the counted "
                         "rank's step) for real")
    ap.add_argument('--device', default=None,
                    help="where --measure runs: the card, or 'cpu'")
    ap.add_argument('--out', default='results/dryrun_torch.jsonl')
    args = ap.parse_args(argv)
    if args.sweep:
        sweep(args.out, use_subprocess=args.subprocess)
        return
    if not (args.arch and args.shape):
        ap.error('--arch and --shape (or --sweep)')
    rec = run_cell(args.arch, args.shape, args.mesh,
                   microbatches=args.microbatches, zero1=not args.no_zero1,
                   rules_variant=args.rules, measure=args.measure,
                   device=args.device)
    print(json.dumps(rec))


if __name__ == '__main__':
    main()
