"""Training and evaluation steps (port of the JAX package's
``train/steps.py``), as plain tensor code on one device.

The JAX trainer scans a whole eval interval of steps inside one compiled
program; here a chunk is a Python loop of eager steps: draw a batch on the
device, run the forward and backward (the hand-written kernels on the card),
update in place.

Optimizer: AdamW with torch's defaults (betas 0.9 / 0.999, eps 1e-8, weight
decay 0.01 on every parameter), written out rather than taken from
``torch.optim``, whose AdamW cannot store bf16 moments with f32 update math.
Two variants, as in the JAX package: ``optax.adamw`` semantics (moments f32,
or mu stored bf16, whose decay product then runs in bf16 as optax's does) and
``_adamw_lowmem`` (mu and nu stored in their own dtypes, all update math in
f32), the production path. Learning-rate schedules follow optax's
warmup-cosine, linear, constant and join semantics, evaluated at the step
count before the increment. Parameters and moments are updated in place.

``tpu_options.fused_update: true`` carries the parameters and both moments
as three flat vectors through a chunk (``Trainer`` with ``fused_update``):
the per-leaf views are one ``torch.split`` of the flat parameter vector, so
the backward hands back one flat gradient (one concatenation), and the
update is one pass of the same elementwise math over the flat vectors
(``AdamW.update_flat_``), bit-equal to the per-leaf update. As in the JAX
package it runs only where every leaf has one dtype, off the sharded
trainers (parallel/trainer.py), and raises a ``TypeError`` on bf16 master
parameters, whose flat update comes out f32.

``rng_impl`` (parsed by config/system.py) is a documented no-op: its values
('auto', 'threefry2x32', 'rbg', 'unsafe_rbg') choose the JAX package's key
implementation, and the port draws from none of them. Randomness comes
from ``StepRng``: a device generator for batches and augmentation and a
host generator for the dropout salts, which key the integer-hash masks
(ops/layers.py) that the JAX package's kernels and layers use; every
``rng_impl`` value trains the same bits (tests/test_torch_options.py).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..models.config import ModelConfig
from ..models.init import map_tree, tree_leaves
from ..models.transformer import forward, total_loss
from ..ops.layers import batch_slice_scope, mod_slice_scope
from ..sampling.feed import BatchFeed
from .metrics import ModalityMetricSpec, batch_directional_metrics

Schedule = Union[float, Callable[[int], float]]
_F32 = torch.float32


def _f32(v: float) -> float:
    """A Python float rounded to f32, as a weak-typed JAX scalar becomes."""
    return float(torch.tensor(v, dtype=_F32))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE (correctly rounded) f32 square root, as XLA's and CUDA's.
    torch's CPU kernel (SLEEF, 0.5001 ulp) misses it on ~0.6% of elements,
    and which ones depends on their place in its vector loop, so on the CPU
    it is taken in f64 and rounded (innocuous double rounding: 53 >= 2 x 24
    + 2 bits). An element's update is then the same in a leaf and in the
    flat vector."""
    return torch.sqrt(x) if x.device.type != "cpu" else torch.sqrt(x.double()).float()


def _linear(init: float, end: float, steps: int, begin: int = 0) -> Callable[[int], float]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = min(max(count - begin, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(float(count), float(decay_steps))
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def _join(schedules: Sequence[Callable], boundaries: Sequence[int]) -> Callable[[int], float]:
    """optax.join_schedules."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def build_lr_schedule(learning_rate: float, spec: Optional[Dict[str, Any]]) -> Schedule:
    """``tpu_options.lr_schedule`` -> a schedule of the step count (or the
    constant learning rate without one): 'cosine' (default), 'linear' or
    'constant' after an optional linear warmup; ``decay_steps`` includes the
    warmup; ``min_lr_ratio`` is the floor as a fraction of the peak."""
    if not spec:
        return learning_rate
    typ = spec.get("type", "cosine")
    warmup = int(spec.get("warmup_steps", 0))
    decay = int(spec["decay_steps"])
    end = learning_rate * float(spec.get("min_lr_ratio", 0.0))
    if typ == "cosine":
        init = 0.0 if warmup else learning_rate
        alpha = 0.0 if learning_rate == 0.0 else end / learning_rate
        return _join([_linear(init, learning_rate, warmup),
                      _cosine(learning_rate, decay - warmup, alpha)], [warmup])
    pieces = []
    if warmup:
        pieces.append(_linear(0.0, learning_rate, warmup))
    if typ == "linear":
        pieces.append(_linear(learning_rate, end, max(decay - warmup, 1)))
    elif typ == "constant":
        pieces.append(lambda count: learning_rate)
    else:
        raise ValueError(f"unknown lr_schedule type {typ!r}")
    return pieces[0] if len(pieces) == 1 else _join(pieces, [warmup])


class AdamW:
    """AdamW over a parameter tree.

    ``lowmem=False``: ``optax.adamw(lr, b1, b2, eps, weight_decay, mu_dtype)``
    (nu f32). ``lowmem=True``: the JAX package's ``_adamw_lowmem`` (mu and nu
    in their own dtypes, update math f32). State: {"count": int, "mu": tree,
    "nu": tree}. ``jax_state_prefix`` and ``schedule_count`` describe where
    the JAX package's optimizer state keeps these (checkpoint keys)."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 mu_dtype: torch.dtype = _F32, nu_dtype: torch.dtype = _F32,
                 lowmem: bool = False):
        if not lowmem and nu_dtype != _F32:
            raise ValueError("optax.adamw keeps nu in f32; a bf16 nu needs lowmem=True")
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu_dtype, self.nu_dtype, self.lowmem = mu_dtype, nu_dtype, lowmem
        # optax.adamw's state is (ScaleByAdamState, add_decayed_weights' empty
        # state, the schedule's count when the lr is a schedule);
        # _adamw_lowmem's is the ScaleByAdamState alone
        self.jax_state_prefix = "" if lowmem else "[0]"
        self.schedule_count = callable(learning_rate) and not lowmem

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": map_tree(lambda p: torch.zeros_like(p, dtype=self.mu_dtype), params),
            "nu": map_tree(lambda p: torch.zeros_like(p, dtype=self.nu_dtype), params),
        }

    def _advance(self, state: Dict[str, Any]) -> Tuple[float, torch.Tensor, torch.Tensor]:
        """Advance ``state["count"]``; the step's learning rate (the schedule
        at the count before the increment) and bias corrections."""
        lr_t = _f32(self.lr(state["count"]))
        state["count"] += 1
        count = torch.tensor(float(state["count"]), dtype=_F32)
        c1 = 1 - torch.tensor(self.b1, dtype=_F32) ** count
        c2 = 1 - torch.tensor(self.b2, dtype=_F32) ** count
        return lr_t, c1, c2

    def apply_(self, p, g, m, v, lr_t: float, c1: torch.Tensor, c2: torch.Tensor) -> None:
        """The update of one tensor (a leaf, or the flat vectors) and its
        moments, in place. Elementwise, so one call over the flat vectors
        gives every element the bits of the per-leaf calls."""
        b1, b2 = self.b1, self.b2
        g32 = g.to(_F32)
        if self.lowmem:
            m32 = b1 * m.to(_F32) + (1.0 - b1) * g32
            v32 = b2 * v.to(_F32) + (1.0 - b2) * g32.square()
            u = (m32 / c1) / (_sqrt(v32 / c2) + self.eps)
            u = u + self.weight_decay * p.to(_F32)
            p.add_((-lr_t * u).to(p.dtype))
        else:
            # the decay product runs in mu's storage dtype, as optax's
            # weak-typed scalar times a bf16 moment does
            m32 = (1.0 - b1) * g32 + (m * torch.tensor(b1, dtype=m.dtype)).to(_F32)
            v32 = (1.0 - b2) * g32.square() + b2 * v
            u = (m32 / c1) / (_sqrt(v32 / c2) + self.eps)
            u = u + self.weight_decay * p
            p.copy_((p + u * -lr_t).to(p.dtype))
        m.copy_(m32.to(m.dtype))
        v.copy_(v32.to(v.dtype))

    @torch.no_grad()
    def update_(self, params, grads: Sequence[torch.Tensor], state: Dict[str, Any]) -> None:
        """One step on the leaves of ``params`` (in place), ``grads`` in
        ``tree_leaves`` order; advances ``state`` in place."""
        lr_t, c1, c2 = self._advance(state)
        for p, g, m, v in zip(tree_leaves(params), grads, tree_leaves(state["mu"]),
                              tree_leaves(state["nu"])):
            self.apply_(p, g, m, v, lr_t, c1, c2)

    @torch.no_grad()
    def update_flat_(self, theta: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, state: Dict[str, Any]) -> None:
        """One step on flat f32 parameters ``theta`` and moments ``mu``,
        ``nu`` (in place), ``grad`` flat in the same order; advances
        ``state["count"]``. The JAX package's fused chunk keeps its flat
        parameters in the scan carry, whose dtype the f32 update must keep:
        bf16 master parameters raise there (a ``TypeError`` of the scan), and
        raise here."""
        if theta.dtype != _F32:
            raise TypeError(f"the flat-state update (fused_update) needs float32 parameters: "
                            f"its update of {theta.dtype} parameters comes out float32")
        self.apply_(theta, grad, mu, nu, *self._advance(state))


def make_optimizer(learning_rate: float, moment_dtype: str = "float32",
                   nu_dtype: str = "float32", lr_schedule: Optional[Dict[str, Any]] = None,
                   params_dtype: str = "float32") -> AdamW:
    """AdamW as the JAX package's ``make_optimizer`` builds it: the lowmem
    variant when nu or the master params are bf16, else optax.adamw with mu
    in ``moment_dtype``."""
    lr = build_lr_schedule(learning_rate, lr_schedule)
    mu = torch.bfloat16 if moment_dtype == "bfloat16" else _F32
    nu = torch.bfloat16 if nu_dtype == "bfloat16" else _F32
    lowmem = nu_dtype == "bfloat16" or params_dtype == "bfloat16"
    return AdamW(lr, mu_dtype=mu, nu_dtype=nu if lowmem else _F32, lowmem=lowmem)


class StepRng:
    """A run's randomness: ``batch``, a generator on the device for batch
    starts and augmentation, and ``host``, a CPU generator for the dropout
    salts (raw uint32[2] per micro-step), both seeded from ``seed``."""

    def __init__(self, seed: int, device: str | torch.device):
        self.batch = torch.Generator(device=torch.device(device)).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed ^ 0x5DEECE66D)

    def salts(self) -> Tuple[int, int]:
        s = torch.randint(0, 1 << 32, (2,), generator=self.host, dtype=torch.int64)
        return int(s[0]), int(s[1])


class EvalStats(NamedTuple):
    """Accumulated over one evaluation pass (eval_iters batches)."""

    mean_loss: torch.Tensor          # mean over batches of the summed CE
    mean_losses: torch.Tensor        # (M,) per-modality mean CE
    wins: torch.Tensor               # (M,)
    losses: torch.Tensor             # (M,)
    certainty: torch.Tensor          # (M,)
    batches_processed: torch.Tensor  # (M,)


@contextlib.contextmanager
def _entered(scopes: Sequence):
    """All of ``scopes`` (context managers) entered, in order."""
    with contextlib.ExitStack() as stack:
        for scope in scopes:
            stack.enter_context(scope)
        yield


class Trainer:
    """Owns the step functions of one (model, feed, optimizer) run.
    ``scope``: a zero-argument context-manager factory entered around every
    training step and evaluation pass (the context-parallel trainer's
    attention scope, parallel/trainer.py). ``data``: this rank's data axis
    (``parallel.mesh.DataAxis``) in a data-parallel run: every batch given
    or drawn is the global batch, of which the rank keeps its rows, with
    its dropout masks keyed by global rows; each step's loss and gradients
    are then the means over the axis, and an evaluation pass's statistics
    its sums. ``fsdp``: the placement of a sharded run's train state on
    this rank (``parallel.trainer.Fsdp``). Where it splits leaves over the
    data axis ``data`` (FSDP) the parameters and moments given are the
    rank's parts; a step gathers the whole parameter tree, takes the
    data-parallel step's gradients on it and reduces them to the rank's
    parts, which the update then changes; an evaluation pass gathers once.
    Where it has a modality axis (``fsdp.mod``, ``parallel.mesh.ModAxis``)
    every batch is the global batch, of which the rank keeps its
    modalities ``mods`` under their scope (``ops.layers.mod_slice_scope``);
    each step's loss and the gradients of the leaves the axis keeps whole
    are then summed over the axis, and an evaluation pass's statistics
    too. ``pipe``: this rank's stage on a pipeline axis
    (``parallel.mesh.PipeAxis``): a training step's loss is then
    ``parallel.pipeline.pipeline_total_loss`` over ``microbatches``
    microbatches (its dropout keys split from the step's salts as a
    threefry key), on the rank's rows of every microbatch under a data axis
    (``pipeline_rows``, keyed by the microbatch's own rows), and each
    leaf's gradient comes from the stage that owns it
    (``PipeAxis.sum_grads``) before the data axis's mean; an evaluation
    pass runs the plain forward on every stage. With a model or modality
    axis under the pipeline (``fsdp.model``, ``fsdp.mod``) every rank
    computes the whole model: a step gathers the leaves they split
    (``Fsdp.gather_split``), and each rank keeps its slices of the whole
    gradients (``Fsdp.split_part``) before the stage sum; no modality
    scope opens and nothing is summed over 'mod'. ``fused_update``: a chunk
    carries the parameters and moments as flat vectors
    (``tpu_options.fused_update: true``; the runner gives it only to the
    one-rank trainer), where every leaf has one dtype."""

    def __init__(self, cfg: ModelConfig, feed: BatchFeed, optimizer: AdamW,
                 metric_specs: Sequence[ModalityMetricSpec], eval_iters: int,
                 grad_accum: int = 1, scope: Optional[Callable] = None, data=None,
                 fused_update: bool = False, fsdp=None, pipe=None, microbatches: int = 4):
        self.cfg = cfg
        self.feed = feed
        self.optimizer = optimizer
        self.metric_specs = list(metric_specs)
        self.eval_iters = eval_iters
        # each step averages gradients over grad_accum microbatch draws
        self.grad_accum = max(1, int(grad_accum))
        self.scope = scope or contextlib.nullcontext
        self.data = data
        self.fused_update = fused_update
        self.pipe = pipe if pipe is not None and pipe.size > 1 else None
        self.microbatches = int(microbatches)
        # under a pipeline axis a rank computes every modality and head: the
        # leaves the model and modality axes split are gathered for a step
        split = self.pipe is not None and fsdp is not None and any(
            (m, o) != (None, None) for m, o in zip(fsdp.model_dims, fsdp.mod_dims))
        self.split = fsdp if split else None
        self.mod = None if fsdp is None or self.pipe is not None else fsdp.mod
        M = cfg.num_modalities
        self.mods = (0, M) if self.mod is None else self.mod.mods(M)
        self.mod_whole = None if self.mod is None else [d is None for d in fsdp.mod_dims]
        self.fsdp = fsdp if fsdp is not None and any(d is not None for d in fsdp.dims) else None

    def _rows(self, xb: torch.Tensor, yb: torch.Tensor, pipelined: bool = False):
        """This rank's modalities and rows of a global (M, B, T) batch (all
        of them without a modality and a data axis), and the scope that
        keys its dropout by global modalities and rows; ``pipelined``: the
        pipeline's rows of every microbatch, keyed by their own rows."""
        if pipelined:
            from ..parallel.pipeline import pipeline_rows

            if self.data is not None:
                rows = pipeline_rows(xb.shape[1], self.microbatches, self.data.rank,
                                     self.data.size).to(xb.device)
                xb, yb = xb[:, rows], yb[:, rows]
            return xb, yb, contextlib.nullcontext()
        scopes = []
        if self.mod is not None:
            m0, per = self.mods
            xb, yb = xb[m0:m0 + per], yb[m0:m0 + per]
            scopes.append(mod_slice_scope(m0, per, self.cfg.num_modalities, self.mod))
        if self.data is not None:
            total = xb.shape[1]
            start, stop = self.data.rows(total)
            xb, yb = xb[:, start:stop], yb[:, start:stop]
            scopes.append(batch_slice_scope(start, total))
        return xb, yb, _entered(scopes)

    # ------------------------------------------------------------- training

    def loss_and_grads(self, params, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                       salts: Sequence[Tuple[int, int]]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Loss and gradients (``tree_leaves`` order) of one step: the mean
        over its microbatches (xb, yb) with their dropout salts (and over
        the data axis; under FSDP of the rank's parts of ``params``; over
        the modality axis the loss and the whole leaves' gradients
        summed; under a pipeline axis with a model or modality axis of the
        rank's parts, computed on the whole tree)."""
        full = self._gathered(params, "all_gather")
        if full is not params:
            full = map_tree(lambda t: t if t.requires_grad else t.requires_grad_(), full)
        loss, grads = self._mod_sum(*self._mean_grads(lambda: full, tree_leaves(full),
                                                      batches, salts))
        if self.split is not None:
            grads = self.split.split_part(grads)
        loss, grads = self._pipe_sum(full, loss, grads)
        if self.fsdp is not None:
            return self.fsdp.reduce_grads(loss, grads)
        if self.data is None:
            return loss, grads
        return self.data.mean_grads(loss, grads)

    def _gathered(self, params, kind: str):
        """The tree a step or an evaluation pass computes on: under FSDP
        gathered over the data axis, under a pipeline axis with a model or
        modality axis gathered over those too (timed as ``kind``, and
        ``"split_" + kind``); else ``params`` itself."""
        if self.fsdp is not None:
            params = self.fsdp.gather(params, kind)
        if self.split is not None:
            params = self.split.gather_split(params, "split_" + kind)
        return params

    def _pipe_sum(self, params, loss: torch.Tensor, grads: List[torch.Tensor]):
        """Over a pipeline axis, each leaf's gradient from the stage that
        owns it (``PipeAxis.sum_grads``); the loss is every stage's."""
        if self.pipe is None:
            return loss, grads
        from ..parallel.pipeline import stage_owners

        owners = stage_owners(params, self.cfg.n_layer, self.pipe.size)
        return loss, self.pipe.sum_grads(grads, owners)

    def _mod_sum(self, loss: torch.Tensor, grads: List[torch.Tensor]):
        """Over a modality axis, the loss and the gradients of the leaves it
        keeps whole summed over the axis (``ModAxis.sum_grads``)."""
        if self.mod is None:
            return loss, grads
        return self.mod.sum_grads(loss, grads, self.mod_whole)

    def _mean_grads(self, make_params: Callable, wrt: Sequence[torch.Tensor], batches,
                    salts) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The mean over the microbatches of the loss and of its gradients
        with respect to ``wrt``, on the parameter tree ``make_params()``
        gives (built anew for each microbatch's graph). The backward runs in
        the scopes of the forward: a rematerialised block (``remat``)
        recomputes its forward there."""
        loss_sum, grad_sum = None, None
        pipe = self.pipe
        for (xb, yb), key in zip(batches, salts):
            xb, yb, rows = self._rows(xb, yb, pipe is not None)
            with self.scope(), rows:
                if pipe is None:
                    loss, _ = total_loss(make_params(), self.cfg, xb, yb, key, True)
                    inputs = list(wrt)
                else:
                    from ..parallel.pipeline import pipeline_total_loss

                    loss, _ = pipeline_total_loss(make_params(), self.cfg, xb, yb, pipe,
                                                  self.microbatches, key, True, self.data)
                    inputs = list(wrt) + [pipe.anchor(xb.device)]  # so the receives' sends run
                # over a modality axis another rank's per-modality leaves
                # (its token table, vocabulary head, cross-attention) go
                # unused here, over a pipeline axis another stage's blocks
                # (and the embedding after the first): their gradient is
                # zero on this rank
                grads = torch.autograd.grad(loss, inputs, allow_unused=self.mod is not None
                                            or pipe is not None)[:len(wrt)]
                grads = [torch.zeros_like(w) if g is None else g for g, w in zip(grads, wrt)]
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            grad_sum = list(grads) if grad_sum is None else [a + b for a, b in zip(grad_sum, grads)]
        if len(batches) > 1:
            inv = 1.0 / len(batches)
            loss_sum, grad_sum = loss_sum * inv, [(g.to(_F32) * inv).to(g.dtype) for g in grad_sum]
        return loss_sum, grad_sum

    def step(self, params, opt_state, batches, salts) -> torch.Tensor:
        """One optimization step on given microbatches and salts; updates
        params and opt_state in place and returns the loss."""
        loss, grads = self.loss_and_grads(params, batches, salts)
        self.optimizer.update_(params, grads, opt_state)
        return loss

    def train_chunk(self, params, opt_state, rng: StepRng, n_steps: int):
        """n_steps training steps with batches drawn on the device; returns
        (params, opt_state, per-step losses (n_steps,))."""

        def draws():
            for _ in range(n_steps):
                batches = [self.feed.get_batch(rng.batch, "train", True)
                           for _ in range(self.grad_accum)]
                yield batches, [rng.salts() for _ in range(self.grad_accum)]

        return self.run_steps(params, opt_state, draws())

    def run_steps(self, params, opt_state, draws: Iterable):
        """One optimization step for each (microbatches, salts) of
        ``draws``; returns (params, opt_state, per-step losses). The
        per-leaf update works in place and returns the trees it was given;
        the flat-state update (``fused_update``, where every leaf has one
        dtype, as the JAX package dispatches) returns trees of views into
        its flat vectors."""
        if self.fused_update and len({t.dtype for t in tree_leaves(params)}) == 1:
            return self._run_steps_flat(params, opt_state, draws)
        losses = [self.step(params, opt_state, b, s) for b, s in draws]
        return params, opt_state, torch.stack(losses)

    def _run_steps_flat(self, params, opt_state, draws: Iterable):
        """``run_steps`` with the parameters and moments carried as three
        flat vectors in ``tree_leaves`` order (the JAX package's
        ``_train_chunk_fused``): one concatenation each at the start, one
        update pass over the vectors a step."""
        sizes = [t.numel() for t in tree_leaves(params)]

        def flat(tree) -> torch.Tensor:
            return torch.cat([t.detach().reshape(-1) for t in tree_leaves(tree)])

        def views(vec: torch.Tensor):
            """The tree of ``params`` as views into vec: one split, whose
            backward is one concatenation of the leaves' gradients (a slice
            a leaf would write a zero vector of the whole length for each)."""
            parts = iter(torch.split(vec, sizes))
            return map_tree(lambda t: next(parts).view(t.shape), params)

        theta = flat(params).requires_grad_()
        mu, nu = flat(opt_state["mu"]), flat(opt_state["nu"])
        state = {"count": opt_state["count"]}
        losses = []
        for batches, salts in draws:
            loss, (grad,) = self._mean_grads(lambda: views(theta), [theta], batches, salts)
            self.optimizer.update_flat_(theta, grad, mu, nu, state)
            losses.append(loss)
        params = map_tree(lambda t: t.requires_grad_(), views(theta.detach()))
        return params, {"count": state["count"], "mu": views(mu), "nu": views(nu)}, torch.stack(losses)

    def train_step(self, params, opt_state, rng: StepRng):
        params, opt_state, losses = self.train_chunk(params, opt_state, rng, 1)
        return params, opt_state, losses[0]

    # ------------------------------------------------------------ evaluation

    @torch.no_grad()
    def eval_pass(self, params, rng: StepRng, split: str) -> EvalStats:
        """eval_iters batches without augmentation: summed CE per batch and
        the directional metrics of every eligible modality (over the global
        batches under a data axis, each rank's modalities over a modality
        axis; under FSDP on the whole tree, gathered once)."""
        params = self._gathered(params, "all_gather_eval")
        M = self.cfg.num_modalities
        dev = self.feed.device
        loss_sum = torch.zeros((), device=dev)
        losses_sum = torch.zeros(M, device=dev)
        wins = torch.zeros(M, dtype=torch.int64, device=dev)
        losses_n = torch.zeros(M, dtype=torch.int64, device=dev)
        cert = torch.zeros(M, device=dev)
        m0, per = self.mods
        for _ in range(self.eval_iters):
            xb, yb, rows = self._rows(*self.feed.sample(rng.batch, split, augment=False))
            with self.scope(), rows:
                logits, ce = forward(params, self.cfg, xb, yb, train=False)
            ce = torch.stack(ce)
            loss_sum = loss_sum + ce.sum()
            losses_sum[m0:m0 + per] += ce
            for m, spec in enumerate(self.metric_specs):
                j = m - m0  # the modality's place in this rank's
                if spec.eligible and 0 <= j < per:
                    w, l, c = batch_directional_metrics(logits[j][:, -1, :], xb[j][:, -1],
                                                        yb[j][:, -1], spec)
                    wins[m] += w
                    losses_n[m] += l
                    cert[m] += c
        processed = torch.tensor([self.eval_iters if s.eligible else 0 for s in self.metric_specs])
        n = float(self.eval_iters)
        stats = EvalStats(loss_sum / n, losses_sum / n, wins, losses_n, cert, processed)
        if self.mod is not None:
            stats = self.mod.sum_eval(stats)
        return stats if self.data is None else self.data.sum_eval(stats)
