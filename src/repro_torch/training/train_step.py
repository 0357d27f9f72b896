"""The train step, as the reference's ``make_train_step``: microbatch
gradient accumulation, remat (inside the model's layer loop), AdamW, and
under a mesh the data-parallel reduce, ZeRO-1 moments and a
tensor-parallel forward and backward.  And the serve step, as the
reference's ``make_serve_step`` (the end of this module): an execution
shape's prefill or decode, meshless for every family, and a rank's step
for every family on a mesh.

Microbatching splits the batch along its leading axis; each microbatch's
gradients are summed in f32 and divided by the count, and the loss is the
mean of the microbatch losses.

**Under a mesh** (``('data', 'model')`` or ``('pod', 'data', 'model')``,
``launch/mesh.py``) each rank is a process holding its blocks
(:class:`TrainPlan`): the weights cut over ``model`` by the family's table
(``distributed/tp.py``: whole heads -- or, where ``model`` does not
divide the kv-heads, the reference's head_dim placement, a block of RoPE
pairs of every head --, ``d_ff`` and vocabulary blocks (where ``model``
does not divide the vocabulary, the embedding's and the head's columns of
d_model), moe's experts and their router columns, rwkv6's wkv heads (or
a block of every head's value channels), zamba2's
Mamba2 heads with a share of B and C -- several intervals of its packed
leaves, ``sharding.Block`` -- and its shared block's heads), and with
ZeRO-1 each moment cut further over the data axes, along a dimension
that holds one interval.  The step computes what GSPMD computes for the
reference on the global batch:

- microbatch i is rows [i B/M, (i+1) B/M) of the global batch, cut over
  the data ranks (:func:`batch_rows` says which rows a rank holds, in
  microbatch order); beyond its rows a rank holds its block of each
  leaf under the reference's ``batch_specs`` (under ``TRAIN_RULES`` the
  sequence over ``model``: :meth:`TrainPlan.batch_block`), gathered
  whole before the model's loss reads it (:meth:`TrainPlan.whole_batch`);
- each microbatch's loss is the masked NLL summed over every data rank
  divided by their summed token count: a rank's objective is its share of
  it (``Model.loss_fn(data=)``, a :class:`DataShare`: its NLL over the
  all-reduced count), so the sum of the ranks' objectives is the global
  loss and a mean of per-rank means never arises; moe routes the global
  microbatch (its capacity, expert ranks and aux loss are the whole
  microbatch's, ``models/moe.py``);
- the gradients, summed in f32 over the microbatches, are all-reduced in
  f32 over the data axes (the sum of the ranks' objectives' gradients is
  the global gradient) and divided by the microbatch count;
- AdamW over the rank's blocks (``optimizer.adamw_update(plan=...)``):
  the global norm over every block once, ZeRO-1's slice update and the
  gather of the parameter's slices.

``loss``, ``lr`` and ``grad_norm`` are then the same on every rank.  The
int8 compressed all-reduce (``training/compression.py``) is a function of
its own, which the step does not call, as in the reference.

``rules`` (``TRAIN_RULES`` by default) is any rule set of
``sharding.RULE_VARIANTS``; the plan places the weights as the reference's
``param_specs(model, mesh, rules)`` do (``distributed.tp.TensorParallel(
rules=)``): ``serve_dh`` replicates attention's projections (rwkv6's time
mix, zamba2's Mamba2 layers and shared attention), which every rank then
runs whole, and cuts the q/k norms (rwkv6's ``u``) on head_dim, gathered
before use; ``serve_kv_dp`` replicates rwkv6's ``u`` and zamba2's
``A_log`` / ``dt_bias`` / ``D``; ``serve_seq`` and ``train_no_sp`` place
the weights as ``TRAIN_RULES`` do.  ``param_specs`` and ``batch_specs``
are the reference's specs under the rules; the port's placement follows
its blocks instead where it departs (the residuals stay replicated over
``model``, the reference's ``TRAIN_NO_SP_RULES``' function, though the
batch's sequence lies as ``TRAIN_RULES`` place it; zamba2's packed
leaves: ``distributed/tp.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import (
    BATCH_AXES, LONG_SERVE_RULES, SERVE_DH_CONTRACT_RULES, SERVE_KV_DP_RULES,
    SERVE_RULES, SERVE_SEQ_RULES, TRAIN_RULES, Block, Sharding,
    batch_coords, check_spec, local_bounds, shaped_spec, tree_spec_shaped)
from repro_torch.distributed.tp import DataShare
from repro_torch.models.api import Model, input_axes_of
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as tr

DATA_AXES = BATCH_AXES
MODEL = 'model'


def loss_and_grads(model: Model, params, batch, microbatches: int = 1):
    """(loss, grads shaped like ``params``) of ``model.loss_fn`` on the
    plain paths.  One microbatch: gradients in the parameters' dtypes; more:
    f32 sums over the microbatches divided by their count."""
    leaves = _grad_leaves(params)
    if microbatches == 1:
        loss, _ = model.loss_fn(params, batch)
        return loss.detach(), tr.unflatten(
            params, torch.autograd.grad(loss, leaves))
    n = _split(batch, microbatches)
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(microbatches):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        loss, _ = model.loss_fn(params, mb)
        gsum = [a + g.to(torch.float32)
                for a, g in zip(gsum, torch.autograd.grad(loss, leaves))]
        lsum = lsum + loss.detach()
    return lsum / microbatches, tr.unflatten(
        params, [g / microbatches for g in gsum])


def _grad_leaves(params) -> list:
    leaves = tr.leaves(params)
    if not all(p.requires_grad for p in leaves):
        raise ValueError('params must require grad: draw them with '
                         'init_params(..., requires_grad=True)')
    return leaves


def _split(batch, microbatches: int) -> int:
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f'batch {b} does not split into {microbatches} '
                         'microbatches')
    return b // microbatches


# ---------------------------------------------------------------------------
# The reference's specs
# ---------------------------------------------------------------------------

def _checked(tree, what):
    if isinstance(tree, dict):
        return {k: _checked(v, what) for k, v in tree.items()}
    check_spec(tree.spec, what)
    return tree


def param_specs(model: Model, mesh, rules=None):
    """The params' ``Sharding`` s under ``TRAIN_RULES`` (the port's (V, D)
    ``unembed`` spec is the reference's (D, V) one read transposed).  A
    spec naming one mesh axis twice is refused."""
    return _checked(tree_spec_shaped(model.param_axes(), model.param_shapes(),
                                     rules or TRAIN_RULES, mesh),
                    'param spec')


def batch_specs(model: Model, shape, mesh, rules=None):
    """The step inputs' ``Sharding`` s for a ``train`` shape."""
    rules = rules or TRAIN_RULES
    specs = model.input_specs(shape)
    return {k: Sharding(mesh, check_spec(
        shaped_spec(specs[k].shape, v, rules, mesh), f'{k} spec'))
        for k, v in model.input_axes(shape).items()}


# ---------------------------------------------------------------------------
# One rank's blocks
# ---------------------------------------------------------------------------

def check_train_mesh(mesh) -> None:
    """What trains under a mesh: every family over the data axes and over
    ``model``; no other axis."""
    other = {a: s for a, s in mesh.shape.items()
             if a not in DATA_AXES + (MODEL,) and s > 1}
    if other:
        raise NotImplementedError(
            f'mesh axes {other}: the trainer reduces over {DATA_AXES} and '
            'splits over model only')


class TrainPlan:
    """Rank ``mesh.rank``'s share of the training state on ``mesh``.

    ``param_blocks``: each weight's :class:`Block` (global bounds; a
    packed leaf's last dimension several intervals) under the
    tensor-parallel plan of ``rules`` (``tp``, None where ``model`` is 1);
    :meth:`moment_block`: with ``zero1``, each moment's block -- its
    param's, cut over the data axes along the dimension
    ``optimizer.zero1_dim`` picks (the rule of ``zero1_moment_specs``, on
    the port's blocks) -- else the param's.  Making a plan makes its
    process groups, which is collective: every rank makes its plan at the
    same point.  With ``coords`` (axis -> coordinate) the plan is another
    rank's blocks only, and makes no group."""

    def __init__(self, model: Model, mesh, *, zero1: bool = True,
                 coords: Optional[dict] = None, rules=None):
        from repro_torch.distributed.tp import TensorParallel

        cfg = model.cfg
        check_train_mesh(mesh)
        check_train_rules(TRAIN_RULES if rules is None else rules)
        self.model, self.mesh = model, mesh
        self.rules = TRAIN_RULES if rules is None else rules
        self.device = mesh.device
        self.data_axes = tuple(a for a in DATA_AXES if a in mesh.axis_names)
        described = coords is not None
        coords = mesh.coords() if coords is None else coords
        self.coords = dict(coords)
        # the reference's spec of each batch leaf a block was taken of
        # (:meth:`batch_block`), by name
        self.batch_leaf_specs: dict = {}
        self.n_data, self.data_index = batch_coords(mesh, coords)
        n_model = mesh.shape.get(MODEL, 1)
        self.tp = (TensorParallel(cfg, mesh, coords, rules=rules)
                   if n_model > 1 else None)
        shapes = dict(tr.leaves_with_paths(model.param_shapes()))
        self.param_blocks, self.zdims = {}, {}
        for path, shape in shapes.items():
            b = (Block.whole(shape) if self.tp is None
                 else self.tp.block(path, shape))
            self.param_blocks[path] = b
            self.zdims[path] = opt.zero1_dim(
                b.shape, [b.intervals(d) != ((0, n),)
                          for d, n in enumerate(b.shape)],
                self.n_data) if zero1 and self.n_data > 1 else None
        self.data_group = self.model_group = self.kv_group = self.data = None
        if described:               # another rank's blocks: no groups
            return
        # the groups, made here on every rank in one order
        if self.n_data > 1:
            self.data_group = mesh.group(self.data_axes)
            self.data = DataShare(self.data_group, self.n_data,
                                  self.data_index)
        self.model_group = self.tp.group if self.tp is not None else None
        self.kv_group = (self.tp.kv_group if self.tp is not None
                         and self.tp.kv_holders > 1 else None)

    # -- the optimizer's view (``optimizer.adamw_update(plan=...)``) -------
    def norm_share(self, path: str) -> str:
        """'replicated' (counted by every rank), 'split' (summed over
        ``model``) or 'duplicate' (another holder counts it)."""
        if self.param_blocks[path].is_whole():
            return 'replicated'
        return 'duplicate' if self.tp.duplicate(path) else 'split'

    def moment_slice(self, path: str):
        """(dim, start, length) of this data rank's ZeRO-1 slice of the
        param block, or None where its moments are the whole block."""
        dim = self.zdims[path]
        if dim is None:
            return None
        n = self.param_blocks[path].local_shape[dim] // self.n_data
        return dim, self.data_index * n, n

    def gather_slices(self, p: torch.Tensor, dim: int) -> None:
        """Every data rank's updated slice of ``p`` (along ``dim``) into
        ``p`` on every data rank."""
        n = p.shape[dim] // self.n_data
        mine = p.narrow(dim, self.data_index * n, n).movedim(dim, 0)
        parts = p.new_empty((self.n_data * n,) + tuple(mine.shape[1:]))
        torch.distributed.all_gather_into_tensor(parts, mine.contiguous(),
                                                 group=self.data_group)
        p.copy_(parts.movedim(0, dim))

    # -- the batch ----------------------------------------------------------
    def batch_block(self, name: str, shape) -> Block:
        """The block of a global batch leaf ``name`` of ``shape`` that this
        rank holds beside its rows (:func:`batch_rows`, the first
        dimension, whole here): the reference's ``batch_specs`` block on
        every other dimension -- under ``TRAIN_RULES`` the sequence over
        ``model``, or where ``model`` does not divide it the dimension
        ``shaped_spec`` moves it to.  The spec is kept for
        :meth:`whole_batch`."""
        spec = check_spec(shaped_spec(tuple(shape),
                                      input_axes_of(name, len(shape)),
                                      self.rules, self.mesh),
                          f'{name} spec')
        self.batch_leaf_specs[name] = spec
        b = local_bounds(tuple(shape), spec, self.mesh, self.coords)
        return b.narrow(0, 0, shape[0])

    def whole_batch(self, batch) -> dict:
        """This rank's rows of a batch (:func:`shard_batch`) with every
        leaf gathered whole beyond the rows, over the axes that cut it
        there (:meth:`batch_block`): the tensors the model's loss reads.
        The residuals stay replicated over ``model`` (``TRAIN_NO_SP_RULES``'
        function); only the arguments lie as the reference's."""
        from repro_torch.distributed.tp import _entry, _gather_stack, unshard

        out = {}
        for k, v in batch.items():
            spec = self.batch_leaf_specs.get(k, ())
            axes = tuple(a for a in self.mesh.axis_names
                         if self.mesh.shape[a] > 1 and any(
                             a in _entry(spec, d) for d in range(1, v.dim())))
            if not axes:
                out[k] = v
                continue
            sizes = [self.mesh.shape[a] for a in axes]
            group = self.mesh.group(axes[0] if len(axes) == 1 else axes)
            parts = _gather_stack(v, group, int(np.prod(sizes)))
            out[k] = unshard(parts.view(tuple(sizes) + tuple(v.shape)), sizes,
                             [()] + [tuple(axes.index(a)
                                           for a in _entry(spec, d)
                                           if a in axes)
                                     for d in range(1, v.dim())])
        return out

    # -- blocks -------------------------------------------------------------
    def moment_block(self, path: str) -> Block:
        b = self.param_blocks[path]
        dim = self.zdims[path]
        return b if dim is None else b.cut(dim, self.n_data, self.data_index)

    def blocks(self):
        """{'params', 'opt'}: the :class:`Block` of every leaf of a training
        state (``checkpoint.save(specs=)`` / ``restore(shardings=)``)."""
        params = tr.unflatten(self.model.param_shapes(),
                              list(self.param_blocks.values()))
        moments = tr.unflatten(self.model.param_shapes(),
                               [self.moment_block(p) for p in self.param_blocks])
        return {'params': params,
                'opt': {'step': Block.whole(()), 'mu': moments,
                        'nu': moments}}

    def shard(self, path, full):
        """This rank's block of the global weight ``full`` at ``path`` (a
        key tuple or ``'a/b'``; a view), as ``TensorParallel.shard``:
        ``Model.init_blocks`` draws a plan's blocks with it."""
        key = path if isinstance(path, str) else '/'.join(path)
        return self.param_blocks[key].take(full)

    def shard_params(self, full, *, requires_grad: bool = True
                     ) -> nn.ParameterDict:
        """The global weights ``full`` cut to this rank's blocks (copies on
        the mesh's device, requiring grad for training)."""
        it = iter(self.param_blocks.values())
        return _parameter_dict(tr.tree_map(
            lambda w: nn.Parameter(_copy(next(it).take(w.detach()),
                                         self.device),
                                   requires_grad=requires_grad), full))

    def init_opt_state(self) -> dict:
        """AdamW's state over this rank's moment blocks (f32 zeros)."""
        def zeros(path):
            b = self.moment_block(path)
            return torch.zeros(b.local_shape, dtype=torch.float32,
                               device=self.device)
        moments = lambda: tr.unflatten(  # noqa: E731
            self.model.param_shapes(), [zeros(p) for p in self.param_blocks])
        return {'step': torch.zeros((), dtype=torch.int32,
                                    device=self.device),
                'mu': moments(), 'nu': moments()}

    def shard_opt_state(self, full) -> dict:
        """A global AdamW state (the port's layout) cut to this rank's
        moment blocks."""
        def cut(tree):
            it = iter(self.param_blocks)
            return tr.tree_map(lambda m: _copy(
                self.moment_block(next(it)).take(m), self.device), tree)
        return {'step': full['step'].to(self.device), 'mu': cut(full['mu']),
                'nu': cut(full['nu'])}


def _copy(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device, memory_format=torch.contiguous_format, copy=True)


def _parameter_dict(tree) -> nn.ParameterDict:
    return nn.ParameterDict({k: _parameter_dict(v) if isinstance(v, dict)
                             else v for k, v in tree.items()})


def batch_rows(global_batch: int, plan: TrainPlan,
               microbatches: int = 1) -> np.ndarray:
    """The rows of a global batch that ``plan``'s rank holds, in microbatch
    order: for each microbatch i, its data rank's block of rows [i B/M,
    (i+1) B/M)."""
    if global_batch % (microbatches * plan.n_data):
        raise ValueError(f'global batch {global_batch} does not split into '
                         f'{microbatches} microbatches over {plan.n_data} '
                         'data ranks')
    per = global_batch // microbatches
    n = per // plan.n_data
    return np.concatenate([np.arange(i * per + plan.data_index * n,
                                     i * per + (plan.data_index + 1) * n)
                           for i in range(microbatches)])


def shard_batch(batch, plan: TrainPlan, microbatches: int = 1):
    """This rank's block of a global batch (host numpy arrays or tensors),
    as tensors on the mesh's device: its rows (:func:`batch_rows`) and,
    beyond them, its block of each leaf under the reference's
    ``batch_specs`` (:meth:`TrainPlan.batch_block`: the sequence over
    ``model`` under ``TRAIN_RULES``)."""
    rows = batch_rows(next(iter(batch.values())).shape[0], plan, microbatches)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)[rows] if isinstance(v, np.ndarray)
                            else v[torch.as_tensor(rows)])
        b = plan.batch_block(k, tuple(v.shape))
        out[k] = _copy(Block(tuple(t.shape), ((0, t.shape[0]),)
                             + b.bounds[1:]).take(t), plan.device)
    return out


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def make_train_step(model: Model, mesh=None, *,
                    opt_cfg: Optional[opt.AdamWConfig] = None,
                    microbatches: int = 1, zero1: bool = True, rules=None):
    """``step(params, opt_state, batch) -> (params, opt_state, {'lr',
    'grad_norm', 'loss'})``, updating params and moments in place.

    Meshless: batch holds tensors on the params' device, split along the
    leading axis into ``microbatches``.  Under ``mesh``: params and
    opt_state are this rank's blocks (``step.plan``, a :class:`TrainPlan`
    placed by ``rules``, ``TRAIN_RULES`` where None: ``shard_params``,
    ``init_opt_state``) and batch its rows of the global batch
    (:func:`shard_batch`); every rank of the mesh calls the step.  A rule
    set that places the weights as none of ``RULE_VARIANTS`` raises
    (:func:`check_train_rules`); meshless, ``rules`` places nothing."""
    ocfg = opt_cfg or opt.AdamWConfig()
    if mesh is None:
        def step(params, opt_state, batch):
            loss, grads = loss_and_grads(model, params, batch, microbatches)
            params, opt_state, metrics = opt.adamw_update(ocfg, params, grads,
                                                          opt_state)
            return params, opt_state, dict(metrics, loss=loss)
        return step

    plan = TrainPlan(model, mesh, zero1=zero1, rules=rules)

    def mesh_step(params, opt_state, batch):
        loss, grads = mesh_loss_and_grads(model, plan, params, batch,
                                          microbatches)
        params, opt_state, metrics = opt.adamw_update(
            ocfg, params, grads, opt_state, plan=plan)
        return params, opt_state, dict(metrics, loss=loss)

    mesh_step.plan = plan
    return mesh_step


def mesh_loss_and_grads(model: Model, plan: TrainPlan, params, batch,
                        microbatches: int = 1):
    """:func:`loss_and_grads` of the global batch on a mesh (module
    docstring): ``params`` this rank's blocks, ``batch`` its rows
    (:func:`shard_batch`).  Returns the global loss and this rank's blocks
    of the global gradients, f32, the same on every data rank."""
    def data_sum(x: torch.Tensor) -> torch.Tensor:
        return x if plan.data is None else plan.data.sum(x)

    leaves = _grad_leaves(params)
    n = _split(batch, microbatches)
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    lsum = torch.zeros((), dtype=torch.float32, device=plan.device)
    for i in range(microbatches):
        mb = plan.whole_batch({k: v[i * n:(i + 1) * n]
                               for k, v in batch.items()})
        part, _ = model.loss_fn(params, mb, tp=plan.tp, data=plan.data)
        gsum = [a + g.to(torch.float32) for a, g in
                zip(gsum, torch.autograd.grad(part, leaves))]
        lsum = lsum + part.detach()
    for g in gsum:
        data_sum(g)
    if microbatches > 1:
        gsum = [g / microbatches for g in gsum]
    return data_sum(lsum) / microbatches, tr.unflatten(params, gsum)


# ---------------------------------------------------------------------------
# The serve step
# ---------------------------------------------------------------------------

# the logical axes whose rules decide where a rank's blocks lie ('seq'
# names no serving tensor, and the trainer's residuals stay replicated)
PLACED_AXES = ('batch', 'heads', 'kv_heads', 'head_dim', 'qkv', 'ffn',
               'vocab', 'expert', 'layers', 'pages', 'kv_seq', 'state',
               'embed')


def _places_as(rules, *known) -> bool:
    return any(all(rules.get(a) == r.get(a) for a in PLACED_AXES)
               for r in known)


def serve_placement_expressible(rules) -> bool:
    """Whether the serve step's plan (``distributed.tp.StepParallel``)
    places what ``rules`` ask for: ``SERVE_RULES`` and ``TRAIN_RULES``
    (whose 'seq' only lays out the residuals), ``LONG_SERVE_RULES`` (the
    rows replicated, a long context's KV sequence over the batch axes) and
    the reference's three serving variants ``serve_kv_dp``, ``serve_seq``
    and ``serve_dh`` (``tp.attention_placement``)."""
    return _places_as(rules, SERVE_RULES, LONG_SERVE_RULES,
                      SERVE_KV_DP_RULES, SERVE_SEQ_RULES,
                      SERVE_DH_CONTRACT_RULES)


def train_placement_expressible(rules) -> bool:
    """Whether the trainer's plan places what ``rules`` ask for: the rows
    over the data axes and the weights as a rule set of ``RULE_VARIANTS``
    does (``TRAIN_RULES`` and ``TRAIN_NO_SP_RULES``, whose 'seq' only lays
    out the residuals; the three serving variants, whose 'pages' and
    'kv_seq' name no training tensor)."""
    return _places_as(rules, TRAIN_RULES, SERVE_KV_DP_RULES,
                      SERVE_SEQ_RULES, SERVE_DH_CONTRACT_RULES)


def check_train_rules(rules) -> None:
    """Raise NotImplementedError for a rule set whose placement the
    trainer does not take (:func:`train_placement_expressible`)."""
    if not train_placement_expressible(rules):
        raise NotImplementedError(
            'a train rule set whose placement is none of RULE_VARIANTS\' '
            '(default, train_no_sp, serve_seq, serve_kv_dp, serve_dh)')


def check_serve_mesh(model: Model, mesh, shape, rules) -> None:
    """What ``make_serve_step`` serves on a mesh, and the rest raising
    NotImplementedError: every family, long_500k too, over the
    ``pod``/``data`` batch axes and ``model``, under a placement the plan
    takes (:func:`serve_placement_expressible`)."""
    if not serve_placement_expressible(rules):
        raise NotImplementedError(
            'a serve rule set whose placement is none of SERVE_RULES, '
            'LONG_SERVE_RULES, serve_kv_dp, serve_seq and serve_dh')
    other = [a for a in mesh.axis_names if a not in DATA_AXES + (MODEL,)]
    if other:
        raise NotImplementedError(f'mesh axes {other}: a serve step runs '
                                  f'over {DATA_AXES} and model only')


def make_serve_step(model: Model, mesh, shape, *, rules=None):
    """The prefill or decode step of an execution ``shape``: ``(step,
    specs)``, as the reference's.  ``step(params, cache, batch) -> (cache,
    f32 scores)``, the cache (:meth:`Model.cache_template` of ``shape``:
    the per-request region layout for the paged families) updated in place.

    Meshless: every family's plain prefill or decode (``long_500k`` decodes
    over hybrid's contiguous KV); ``specs`` is None.  On a mesh, every
    family: the rank's step over its blocks (``step.plan``, a
    ``distributed.tp.StepParallel``: ``shard_params``, ``shard_cache``,
    ``shard_batch``), returning its rows' scores over its vocabulary
    block; under ``LONG_SERVE_RULES`` (long_500k) the rows are replicated
    and zamba2's contiguous KV sequence is split over the batch axes; under
    the variants ``RULE_VARIANTS['serve_kv_dp' | 'serve_seq' | 'serve_dh']``
    the pool and attention's heads lie as the plan's ``placement`` says.  ``specs`` is the reference's ``dict(params=, cache=, batch=)``
    of ``Sharding`` s under ``rules`` (``LONG_SERVE_RULES`` for long_500k,
    else ``SERVE_RULES``)."""
    if rules is None:
        rules = LONG_SERVE_RULES if shape.name == 'long_500k' else SERVE_RULES
    long_ctx = shape.name == 'long_500k'
    prefill = shape.kind == 'prefill'
    if mesh is None:
        def step(params, cache, batch):
            if prefill:
                return model.prefill_fn(params, cache, batch)
            return model.decode_fn(params, cache, batch,
                                   long_context=long_ctx)
        return step, None

    from repro_torch.distributed.tp import StepParallel

    check_serve_mesh(model, mesh, shape, rules)
    plan = StepParallel(model.cfg, mesh, batch=shape.global_batch,
                        seq_len=shape.seq_len, rules=rules)

    def mesh_step(params, cache, batch):
        if prefill:
            return model.prefill_fn(params, cache, batch, tp=plan)
        return model.decode_fn(params, cache, batch, long_context=long_ctx,
                               tp=plan)

    mesh_step.plan = plan
    ispecs = model.input_specs(shape)
    specs = dict(
        params=tree_spec_shaped(model.param_axes(), model.param_shapes(),
                                rules, mesh),
        cache=tree_spec_shaped(model.cache_axes(shape),
                               model.cache_shapes(shape), rules, mesh),
        batch={k: Sharding(mesh, shaped_spec(ispecs[k].shape, v, rules, mesh))
               for k, v in model.input_axes(shape).items()})
    return mesh_step, specs
