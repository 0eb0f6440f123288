"""Training step construction: microbatch gradient accumulation, mixed
precision, AdamW, metrics. Counterpart of ``repro.train.train_loop``.

Remat happens inside the model (``cfg.remat``: each block's forward runs
under ``torch.utils.checkpoint``). ``make_train_step`` takes the JAX
package's ``mesh`` and ``param_specs``: on a single controller the mesh
must hold one device (a local mesh), and the sharding constraints are
checked, not applied, so the step equals the meshless one.

:func:`train_state_tree` and :func:`load_train_state` lay a training state
out as the JAX launcher checkpoints it, ``{"params": <init_lm tree>,
"opt": OptState(step, m, v)}``, so a checkpoint written by either package
restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch import shardings
from repro_torch.launch.mesh import dp_size
from repro_torch.models import convert, lm
from repro_torch.models.common import ModelConfig
from repro_torch.train import optim
from repro_torch.utils.tree import tree_map


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _grad(total, leaves) -> tuple:
    """Gradients of ``total``, zeros for leaves it does not use (the
    embedding of the audio frontend), as ``jax.grad`` gives."""
    return torch.autograd.grad(total, leaves, allow_unused=True,
                               materialize_grads=True)


def loss_and_grads(params: lm.TransformerLM, cfg: ModelConfig,
                   batch: dict, microbatches: int = 1,
                   acc_dtype=torch.float32):
    """``(loss, metrics, grads)`` of ``lm_loss`` at ``params``, the
    counterpart of ``jax.value_and_grad(lm_loss, has_aux=True)``:
    ``grads`` maps each parameter name to its gradient. ``params`` is
    switched to take gradients; ``batch`` holds numpy arrays or tensors,
    moved to the model's device.

    With ``microbatches > 1`` the batch is split along dim 0 and the
    microbatches' gradients are added, in order, into an ``acc_dtype``
    accumulator, then divided by their count, as are the losses; metrics
    are then empty, as the JAX package's."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    leaves = list(named.values())
    batch = _to_device(batch, leaves[0].device)
    if microbatches == 1:
        total, metrics = lm.lm_loss(params, cfg, batch)
        grads = _grad(total, leaves)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(named, grads))
    micro = {}
    for k, x in batch.items():
        b = x.shape[0]
        assert b % microbatches == 0
        micro[k] = x.reshape(microbatches, b // microbatches, *x.shape[1:])
    grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
             for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(microbatches):
        total, _ = lm.lm_loss(params, cfg,
                              {k: x[i] for k, x in micro.items()})
        for acc, g in zip(grads, _grad(total, leaves)):
            acc.add_(g.to(acc_dtype))
        loss = loss + total.detach()
    return loss / microbatches, {}, \
        {name: g / microbatches for name, g in zip(named, grads)}


def _check_layout(cfg: ModelConfig, mesh, param_specs, params, batch,
                  microbatches: int) -> None:
    """The JAX step's sharding constraints, checked: the microbatch split
    keeps its batch dim over the DP axes, and the accumulator (shaped as
    the parameters) divides as ``param_specs`` says."""
    if microbatches > 1 and "data" in mesh.axis_names:
        for k, x in batch.items():
            if (x.shape[0] // microbatches) % dp_size(mesh):
                raise ValueError(
                    f"batch {k!r}: {x.shape[0]} rows in {microbatches} "
                    f"microbatches do not divide over {dp_size(mesh)} "
                    "DP shards")
    if param_specs is not None:
        shardings.check_specs(convert.param_shapes(cfg, params),
                              param_specs, mesh)


def make_train_step(cfg: ModelConfig, ocfg: optim.OptConfig,
                    microbatches: int = 1, mesh=None, param_specs=None,
                    acc_dtype=torch.float32):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: :func:`loss_and_grads`, then one
    :func:`~repro_torch.train.optim.adamw_update`, which updates the
    :class:`TransformerLM`'s parameters in place. Metrics: ``loss``,
    ``grad_norm``, ``lr``, and with one microbatch ``lm_loss``'s own
    (``nll``, ``lb_loss``, ``z_loss``, ``drop_frac``), as 0-d tensors.

    ``mesh`` (``launch.mesh.Mesh``) and ``param_specs`` (a spec tree in
    ``repro``'s layout, ``launch.shardings.param_specs``) are the JAX
    step's: its first call checks the constraints that step places (see
    :func:`_check_layout`). A single controller keeps every tensor whole
    on one device, so the mesh must hold one device; a mesh over distinct
    devices raises, since training across cards needs a multi-card
    machine and one process per card."""
    if mesh is not None and len(mesh.distinct_devices) > 1:
        raise NotImplementedError(
            f"the mesh spans {len(mesh.distinct_devices)} distinct devices: "
            "training across cards needs a multi-card machine (one process "
            "per card); a local mesh (launch.mesh.make_local_mesh) trains "
            "on one")
    checked = []

    def train_step(params: lm.TransformerLM, opt_state: optim.OptState,
                   batch: dict):
        if mesh is not None and not checked:
            _check_layout(cfg, mesh, param_specs, params, batch,
                          microbatches)
            checked.append(True)
        loss, metrics, grads = loss_and_grads(params, cfg, batch,
                                              microbatches, acc_dtype)
        _, new_opt, opt_metrics = optim.adamw_update(
            grads, dict(params.named_parameters()), opt_state, ocfg)
        return params, new_opt, {"loss": loss, **opt_metrics, **metrics}

    return train_step


def train_many(params, opt_state, train_step, batches):
    """Simple host loop used by tests/examples."""
    history = []
    for batch in batches:
        params, opt_state, metrics = train_step(params, opt_state, batch)
        history.append({k: float(v) for k, v in metrics.items()
                        if v.ndim == 0})
    return params, opt_state, history


# ---------------------------------------------------------------------------
# the training state in the JAX package's checkpoint layout
# ---------------------------------------------------------------------------

def _host(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x)
    return x


def train_state_tree(cfg: ModelConfig, params: lm.TransformerLM,
                     opt: optim.OptState) -> dict:
    """``{"params", "opt"}`` as numpy in ``repro.launch.train``'s layout:
    the ``init_lm`` tree, and ``OptState(step, m, v)`` whose moments
    (arrays or ``Q8``) are laid out as the params."""
    def tree(named):
        return convert.to_repro_tree(cfg, tree_map(_host, named))
    return {"params": tree(dict(params.named_parameters())),
            "opt": optim.OptState(step=_host(opt.step), m=tree(opt.m),
                                  v=tree(opt.v))}


@torch.no_grad()
def load_train_state(cfg: ModelConfig, tree: dict, params: lm.TransformerLM,
                     opt: optim.OptState) -> optim.OptState:
    """Copy a training state in the layout of :func:`train_state_tree`
    (numpy, e.g. from ``CheckpointManager.restore``) into ``params`` and
    ``opt`` in place; returns the optimizer state with its restored
    step."""
    named = dict(params.named_parameters())
    for name, arr in convert.from_repro_tree(cfg, tree["params"]).items():
        named[name].copy_(torch.from_numpy(np.asarray(arr)))
    for dst, src in (
            (opt.m, convert.from_repro_tree(cfg, tree["opt"].m)),
            (opt.v, convert.from_repro_tree(cfg, tree["opt"].v))):
        for name, val in src.items():
            if isinstance(val, optim.Q8):
                dst[name].q.copy_(torch.from_numpy(np.asarray(val.q)))
                dst[name].scale.copy_(torch.from_numpy(np.asarray(
                    val.scale)))
            else:
                dst[name].copy_(torch.from_numpy(np.asarray(val)))
    step = torch.as_tensor(np.asarray(tree["opt"].step)).to(opt.step)
    return optim.OptState(step=step, m=opt.m, v=opt.v)
