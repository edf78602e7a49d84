"""The tiled training step in plain torch: bin afresh, composite every tile
over its full K list, the mean squared error against the target, autograd
for the gradients and Adam written out (the semantics of the port's
``parallel/train.make_tiled_train_step`` with ``make_optimizer``)."""
from __future__ import annotations

import torch

from . import tiles as tiles_mod
from .types import SCENE_FIELDS, GaussianScene

BETAS, EPS = (0.9, 0.999), 1e-8


def fit_steps(leaves: dict, cams, targets, settings, config, lr: float,
              steps: int, lowp: bool = False, loss_rows=None) -> dict:
    """Run ``steps`` steps from ``leaves`` (the scene's 11 fields), step i
    on ``cams[i]`` against ``targets[i]``. ``loss_rows`` (H,) bool, when
    given, keeps only those image rows in the loss (a planted fault).

    Returns dict(losses [float], grad1 {field: first gradient},
    params {field: the leaves after the last step}).
    """
    b1, b2 = BETAS
    params = {f: leaves[f].detach().clone().requires_grad_(True)
              for f in SCENE_FIELDS}
    m = {f: torch.zeros_like(p) for f, p in params.items()}
    v = {f: torch.zeros_like(p) for f, p in params.items()}
    losses, grad1 = [], None
    for i in range(steps):
        img = tiles_mod.render_image(GaussianScene(**params), cams[i],
                                     settings, config, lowp)
        err = (img - targets[i]) ** 2
        loss = torch.mean(err if loss_rows is None else err[loss_rows])
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (f, p), g in zip(params.items(), grads):
                if g is None:
                    continue
                m[f] = b1 * m[f] + (1 - b1) * g
                v[f] = b2 * v[f] + (1 - b2) * g * g
                mhat = m[f] / (1 - b1 ** (i + 1))
                vhat = v[f] / (1 - b2 ** (i + 1))
                p -= lr * mhat / (torch.sqrt(vhat) + EPS)
        if i == 0:
            grad1 = {f: (g.detach() if g is not None
                         else torch.zeros_like(params[f]))
                     for f, g in zip(params, grads)}
        del img, err, loss, grads
    return dict(losses=losses, grad1=grad1,
                params={f: p.detach() for f, p in params.items()})


@torch.no_grad()
def render_targets(leaves: dict, cams, settings, config) -> list:
    """The images of the scene ``leaves`` from ``cams`` (no gradient)."""
    scene = GaussianScene(**leaves)
    return [tiles_mod.render_image(scene, c, settings, config) for c in cams]
