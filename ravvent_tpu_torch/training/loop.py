"""Training: train and validation steps and the fit loop (counterpart of
ravvent_tpu/training/loop.py; reference: ravvent.py:11-88 and
basecaller.py:222-283).

keras ``Model.fit`` becomes an explicit loop over steps, as in the JAX
package:

- the optimizer is Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0, bias correction) after keras ``clipnorm``: each gradient
  tensor clipped to its own L2 norm, not a global norm (reference:
  ravvent.py:53-55);
- the train step runs the encoders' plain version, which autograd
  differentiates; the JAX package trains through its scan for the same
  reason (its Pallas layer has no VJP, ravvent_tpu/models/rnn.py:325-326).
  The validation step runs the encoder kernel on a CUDA tensor, then a
  plain greedy decode with the reference's batch-max length bound;
- parameters stay in the JAX tree's layout (models/basecaller.py), each
  leaf a tensor that requires grad.

Data-parallel training (``num_data_shards = N > 1``, the JAX trainer's
batch-sharded ``jit`` with replicated parameters, ravvent_tpu/training/
loop.py:140-151) runs one process a shard in a process group of world size
N (parallel/distributed.py:initialize). Every rank is given the same
global batch and keeps its ``local_batch_slice`` rows; it equals one
process's step on the global batch:

- the loss's normalizer, the non-pad count, is summed over the ranks before
  the division, each rank's loss is its share of the global mean, and the
  gradients (and the shares) are summed in one flat all-reduce a step; a
  mean of per-rank means would be wrong whenever the shards' counts differ;
- the train accuracy's match count and total are summed likewise;
- scheduled sampling's draws are the global batch's, from the same seeded
  generator on every rank, each rank keeping its rows;
- validation's batch-max width and greedy all-finished stop, and its loss
  and accuracy, are the global batch's;
- rank 0's initial parameters and generator state are broadcast at
  construction; clipping and
  Adam then run on every rank on the same summed gradients, so the ranks'
  parameters stay equal bit for bit. Only rank 0 writes checkpoints and the
  CSV log.

With ``model_shards = k > 1`` (the JAX trainer on a ``('data', 'model')``
mesh, ravvent_tpu/training/loop.py:103-139) the world is a grid of N data
shards by k model ranks (parallel/distributed.py:grid_axes; rank r is data
index r // k, model index r % k). The k ranks of a model row train on the
same data shard, each on a slice of the attention memory's positions, in
the train step and in validation (models/basecaller.py:shard_attention):
every decode step reduces the softmax and the context across the row. The
reductions above then run over a data column instead of the world (the
initial broadcast still reaches every rank), and the ranks of a row
compute the same loss, gradients and metrics.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Union

import numpy as np
import torch

from ravvent_tpu_torch.config import RunConfig
from ravvent_tpu_torch.decode.greedy import greedy_decode
from ravvent_tpu_torch.evaluation.basecall import resolve_device
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models.basecaller import (
    PAD, check_config, encode_input, init_basecaller, shard_attention, train_forward, val_metrics,
)
from ravvent_tpu_torch.models.decoder import scheduled_draws
from ravvent_tpu_torch.parallel import distributed
from ravvent_tpu_torch.training.logging import CSVLogger

if TYPE_CHECKING:
    from ravvent_tpu_torch.training.checkpoints import CheckpointManager

Params = Dict[str, Any]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict/list tree, dicts in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like, leaves: Iterable[torch.Tensor]):
    """The leaves, in :func:`tree_leaves` order, in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def per_leaf_clip_by_norm(grads, max_norm: float):
    """keras ``clipnorm``: each gradient tensor scaled to an L2 norm of at
    most ``max_norm`` on its own, ``min(1, max_norm / max(n, 1e-12))``; not
    a global norm."""
    def clip(g):
        n = torch.sqrt(torch.sum(torch.square(g)))
        return g * torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)

    return tree_map(clip, grads)


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and both moments."""
    count: int
    mu: Params
    nu: Params


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state) -> (updates,
    state)``, the updates to add to the parameters (:func:`apply_updates`)."""
    init: Callable
    update: Callable


def make_optimizer(learning_rate: float, clipnorm: Optional[float] = None, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam as optax computes it (``optax.chain(per_leaf_clip_by_norm,
    optax.adam)`` in the JAX package): mu and nu updated, both bias-corrected
    by ``1 - b**count``, the update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``."""
    def init(params) -> AdamState:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params))

    def update(grads, state: AdamState):
        if clipnorm is not None:
            grads = per_leaf_clip_by_norm(grads, clipnorm)
        count = state.count + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * torch.square(g) + b2 * v, grads, state.nu)
        # f32, as optax computes them; 0-dim CPU tensors serve any device
        bc1, bc2 = (1.0 - torch.tensor(b, dtype=torch.float32) ** count for b in (b1, b2))

        def step(m, v):
            return -learning_rate * ((m / bc1) / (torch.sqrt(v / bc2) + eps))

        return tree_map(step, mu, nu), AdamState(count, mu, nu)

    return Optimizer(init, update)


def apply_updates(params, updates) -> None:
    """``params += updates`` leaf by leaf, in place."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u)


def as_trainable(params, device: torch.device):
    """Fresh f32 leaves on ``device`` that require grad, each dict's keys
    sorted: ranks given trees in other key orders (a JAX tree's,
    ``init_basecaller``'s) then agree leaf for leaf in the flat broadcast
    and all-reduce."""
    if isinstance(params, dict):
        return {k: as_trainable(params[k], device) for k in sorted(params)}
    if isinstance(params, (list, tuple)):
        return [as_trainable(v, device) for v in params]
    return torch.as_tensor(params).detach().to(device, torch.float32).clone().requires_grad_(True)


class Trainer:
    """Trains the model. ``params``: a tree in the port's layout (e.g.
    ``weights.from_jax_params`` of a JAX tree, or a restored checkpoint's),
    else seeded weights from ``init_basecaller``. ``device``: the card
    unless ``"cpu"`` is asked for. Scheduled sampling draws from
    ``self.rng``, a ``torch.Generator`` on the device seeded from
    ``random_seed`` (or ``seed``); its stream differs from jax.random's, so
    only ``teacher_forcing >= 1`` (p = 0) repeats the JAX trainer's steps.
    With ``num_data_shards * model_shards > 1`` this process is one rank
    of a grid of that many (the module's docstring) and needs an
    initialized process group of that world size; every rank constructs
    its trainer at the same point, since that creates the grid's groups."""

    def __init__(self, cfg: RunConfig, params: Optional[Params] = None,
                 device: Union[str, torch.device, None] = None, seed: Optional[int] = None,
                 model_shards: int = 1):
        self.cfg = cfg
        self.mcfg = cfg.model
        self.tcfg = cfg.train
        check_config(self.mcfg)
        self.n_shards = self.tcfg.num_data_shards
        self.rank, world = distributed.process_info()
        ranks = self.n_shards * model_shards
        if ranks > 1 and world != ranks:
            raise RuntimeError(
                f"num_data_shards={self.n_shards} x model_shards={model_shards} trains one process "
                f"a rank: initialize a process group of world size {ranks} first "
                f"(parallel.distributed.initialize); this process's world size is {world}")
        self.data_axis, model_axis = distributed.grid_axes(self.n_shards, model_shards)
        self.model_axis = model_axis if model_shards > 1 else None
        self._reduce = self.data_axis.all_reduce if self.n_shards > 1 else None
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(self.tcfg.learning_rate, self.tcfg.clipnorm)
        tf = float(self.tcfg.teacher_forcing)
        # teacher_forcing (reference: basecaller.py:96-107): 1.0 is pure
        # teacher forcing; a float p is scheduled sampling with probability p
        # of feeding the model's own sampled token
        self.sampling_probability = 0.0 if tf >= 1.0 else tf
        seed = self.tcfg.random_seed if seed is None else seed
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        if params is None:
            params = init_basecaller(self.mcfg, torch.Generator().manual_seed(seed))
        self.params = as_trainable(params, self.device)
        if ranks > 1:  # rank 0's initial parameters and generator on every rank
            with torch.no_grad():
                leaves = tree_leaves(self.params)
                flat = distributed.broadcast(torch.cat([p.reshape(-1) for p in leaves]), 0)
                for p, v in zip(leaves, flat.split([p.numel() for p in leaves])):
                    p.copy_(v.view_as(p))
            self.rng.set_state(distributed.broadcast(self.rng.get_state(), 0))
        self.opt_state = self.optimizer.init(self.params)

    def load_state(self, state: Dict[str, Any]) -> None:
        """Take a restored checkpoint (``CheckpointManager.restore``): its
        parameters, and its optimizer and generator state where saved."""
        self.params = as_trainable(state["params"], self.device)
        if "opt_state" in state:
            o = state["opt_state"]
            to_dev = lambda t: torch.as_tensor(t).to(self.device, torch.float32)  # noqa: E731
            self.opt_state = AdamState(int(o.count), tree_map(to_dev, o.mu), tree_map(to_dev, o.nu))
        else:
            self.opt_state = self.optimizer.init(self.params)
        if "rng" in state:
            self.rng.set_state(state["rng"])

    def _rows(self, global_batch: int) -> slice:
        return distributed.local_batch_slice(global_batch, self.data_axis.index, self.n_shards)

    def _to_device(self, batch):
        """The batch's rows this process trains on, as device tensors: the
        whole batch, or its data shard's ``local_batch_slice``."""
        raw, event, targets = (np.asarray(x) for x in batch)
        if self.n_shards > 1:
            if targets.shape[0] % self.n_shards:
                raise ValueError(f"a batch of {targets.shape[0]} rows does not split over "
                                 f"{self.n_shards} data shards")
            rows = self._rows(targets.shape[0])
            raw, event, targets = raw[rows], event[rows], targets[rows]
        dev = self.device
        return (torch.as_tensor(raw, dtype=torch.float32).to(dev),
                torch.as_tensor(event, dtype=torch.float32).to(dev),
                torch.as_tensor(targets, dtype=torch.int64).to(dev))

    def loss_and_grads(self, batch):
        """(TrainOutput, gradient tree) of one batch at the current
        parameters; the step's draws come from ``self.rng``. Data-parallel:
        the global batch's loss, accuracy and gradients (summed over a
        data column); the logits are this data shard's rows'."""
        raw, event, targets = self._to_device(batch)
        draws = None
        if self.n_shards > 1 and self.sampling_probability > 0.0:
            B, T = np.asarray(batch[2]).shape
            select, gumbel = scheduled_draws(self.rng, T - 1, B, self.mcfg.vocab_size,
                                             self.sampling_probability, self.device)
            rows = self._rows(B)
            draws = (select[:, rows], gumbel[:, rows])
        out = train_forward(self.params, raw, event, targets, self.mcfg,
                            self.sampling_probability, self.rng, draws, self._reduce,
                            self.model_axis)
        leaves = tree_leaves(self.params)
        grads = torch.autograd.grad(out.loss, leaves)
        if self.n_shards > 1:
            # one all-reduce a step: the gradients and the loss shares
            flat = torch.cat([g.reshape(-1) for g in grads] + [out.loss.detach().reshape(1)])
            self.data_axis.all_reduce(flat, "sum")
            *grads, loss = flat.split([p.numel() for p in leaves] + [1])
            grads = [g.view_as(p) for g, p in zip(grads, leaves)]
            out = out._replace(loss=loss[0])
        return out, tree_unflatten(self.params, grads)

    def train_on_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Value, gradient, clip, then Adam. Returns the step's loss and
        accuracy as device scalars (no host sync)."""
        out, grads = self.loss_and_grads(batch)
        self.apply_gradients(grads)
        return {"loss": out.loss.detach(), "acc": out.acc.detach()}

    def apply_gradients(self, grads) -> None:
        """Clip and Adam: the parameters updated in place by a gradient tree
        (:meth:`loss_and_grads`'s)."""
        with torch.no_grad():
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state)
            apply_updates(self.params, updates)

    def validate_on_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The encoders (the BiLSTM kernel on the card), un-projected f32
        memory and a plain greedy decode of ``T - 1`` steps bounded by the
        batch-max target length (reference quirk #4), then
        :func:`val_metrics`. The bound is read from the host batch, which a
        data-parallel rank is given whole: its metrics are the global
        batch's. On a grid the memory is sharded over the model row, as in
        the train step."""
        raw, event, targets = self._to_device(batch)
        max_steps = int((np.asarray(batch[2]) != PAD).sum(axis=1).max()) - 1
        with torch.no_grad():
            enc_out, mask = encode_input(self.params, raw, event, self.mcfg)
            dec_params, enc_out, mask = shard_attention(self.params["decoder"], enc_out, mask,
                                                        self.model_axis)
            mem = attn.setup_memory(dec_params["attention"], enc_out, mask)
            tokens, logits = greedy_decode(dec_params, mem, self.mcfg.vocab_size,
                                           targets.shape[1] - 1, max_steps,
                                           self.mcfg.effective_attention, self.mcfg.cell_type,
                                           reduce=self._reduce, model_axis=self.model_axis)
            loss, acc = val_metrics(targets[:, 1:], tokens, logits, targets, self._reduce)
        return {"loss": loss, "acc": acc}

    def fit(self, train_gen, val_gen=None, epochs: Optional[int] = None,
            steps_per_epoch: Optional[int] = None, validation_steps: Optional[int] = None,
            initial_epoch: int = 0, csv_log_path: Optional[str] = None,
            checkpoint_manager: Optional["CheckpointManager"] = None,
            batch_callbacks: Iterable[Callable[[int, Dict[str, float]], None]] = (),
            verbose: bool = True) -> Dict[str, list]:
        """Train ``epochs`` epochs of ``steps_per_epoch`` batches, validating
        after each; returns the history of the epochs' mean metrics.
        Data-parallel: each step's metrics are the global batch's, so every
        rank's history is the same; only rank 0 prints, writes the CSV log
        and the checkpoints."""
        epochs = epochs if epochs is not None else self.tcfg.epochs
        steps_per_epoch = steps_per_epoch or self.tcfg.steps_per_epoch
        validation_steps = validation_steps or self.tcfg.validation_steps
        writer = self.rank == 0
        verbose = verbose and writer
        csv = CSVLogger(csv_log_path) if csv_log_path and writer else None
        batch_callbacks = tuple(batch_callbacks)

        history: Dict[str, list] = {"loss": [], "acc": [], "val_loss": [], "val_acc": []}
        for epoch in range(initial_epoch, epochs):
            t0 = time.perf_counter()
            # metrics stay on the device until the epoch ends: one host sync
            # an epoch, not one a step; callbacks opt back into a sync a step
            device_metrics = []
            for i, batch in enumerate(train_gen.steps(steps_per_epoch)):
                m = self.train_on_batch(batch)
                device_metrics.append(torch.stack([m["loss"], m["acc"]]))
                if batch_callbacks:
                    lf, af = (float(v) for v in device_metrics[-1].cpu())
                    for cb in batch_callbacks:
                        cb(i, {"loss": lf, "acc": af})
                if verbose and (i + 1) % 100 == 0:
                    dt = time.perf_counter() - t0
                    print(f"  step {i + 1}/{steps_per_epoch} loss {float(m['loss']):.4f} "
                          f"({dt / (i + 1):.3f}s/step)", flush=True)
            metrics = dict(zip(("loss", "acc"), mean_rows(device_metrics)))

            if val_gen is not None:
                vms = [self.validate_on_batch(batch) for batch in val_gen.steps(validation_steps)]
                metrics["val_loss"], metrics["val_acc"] = mean_rows(
                    [torch.stack([m["loss"], m["acc"]]) for m in vms])

            for k, v in metrics.items():
                history.setdefault(k, []).append(v)
            if csv:
                csv.log(epoch, metrics)
            if checkpoint_manager is not None and writer:
                # the reference's schema: one directory per epoch, every epoch
                checkpoint_manager.save(
                    self.cfg.checkpoint_path(epoch + 1), self.params, self.opt_state,
                    epoch=epoch + 1, rng=self.rng,
                    data_seed=getattr(train_gen, "random_seed", 0))
            if verbose:
                dt = time.perf_counter() - t0
                msg = " - ".join(f"{k}: {v:.4f}" for k, v in metrics.items())
                print(f"epoch {epoch + 1}/{epochs} [{dt:.1f}s] {msg}", flush=True)
        return history


def mean_rows(rows: List[torch.Tensor]) -> List[float]:
    """The column means of device rows, fetched in one copy (zeros for no
    rows)."""
    if not rows:
        return [0.0, 0.0]
    host = torch.stack(rows).double().cpu().numpy()
    return [float(v) for v in host.sum(axis=0) / len(rows)]
