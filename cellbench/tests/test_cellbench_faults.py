"""A run with the timed path broken underneath comes out not correct: the
rest of the run as ``run.py`` drives it (set-up, window, comparison), on
the CPU at the rehearsal's sizes. One case a fault the cell can have: a
step that leaves its state unchanged, half of the batch left out with the
mean taken over the rest, an answer altered where it is produced. (Each
cell runs on one card: no exchange between cards to leave out.) The
interactive view's camera besides: a cursor event mapped to the wrong
angles, and a move that does not reset the accumulation. The sound run
and the control, the reference in bfloat16 in the program's place, are
cases too."""
import functools

import pytest
import torch

from cellbench.rehearse import rehearse

CAPTURE = "pathtracer_gaussiansplatting_tpu_torch.data.capture"
SESSION = "pathtracer_gaussiansplatting_tpu_torch.render.session"
TRAIN = "pathtracer_gaussiansplatting_tpu_torch.parallel.train"


def keep_state(prev, cur, frame):
    return prev


def half_samples(accumulate, prev, cur, frame):
    """Only the even samples, averaged: the odd half left out."""
    if frame % 2:
        return prev
    return accumulate(prev, cur, frame // 2)


def altered(fn, *a, **kw):
    """The sample's radiance 5% off where the path tracer makes it."""
    out = fn(*a, **kw)
    if isinstance(out, tuple):
        return (out[0] * 1.05,) + out[1:]
    return out * 1.05


def patch_accumulate(mp, module, fault):
    import importlib
    mod = importlib.import_module(module)
    if fault == "unchanged":
        mp.setattr(mod, "accumulate", keep_state)
    elif fault == "half":
        mp.setattr(mod, "accumulate",
                   functools.partial(half_samples, mod.accumulate))
    else:
        mp.setattr(mod, "pathtrace_camera",
                   functools.partial(altered, mod.pathtrace_camera))


def patch_fit(mp, fault):
    import importlib
    train = importlib.import_module(TRAIN)
    if fault == "unchanged":
        mp.setattr(torch.optim.Adam, "step",
                   lambda self, closure=None: None)
    elif fault == "half":
        def half_rows(pred, target):
            return torch.mean((pred[::2] - target[::2]) ** 2)
        make = train.make_tiled_train_step
        mp.setattr(train, "make_tiled_train_step",
                   lambda *a, **kw: make(*a, loss_fn=half_rows, **kw))
    else:
        render = train.render_prepared

        def brighter(*a, **kw):
            out = render(*a, **kw)
            return dict(out, color=out["color"] * 1.05)
        mp.setattr(train, "render_prepared", brighter)


CELLS = {"capture.surface500k": lambda mp, f: patch_accumulate(
    mp, CAPTURE, f), "interact.surface500k": lambda mp, f: patch_accumulate(
    mp, SESSION, f), "fit.cloud1m": patch_fit}


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    CELLS[workload](monkeypatch, fault)
    res = rehearse(workload, seconds=0.5)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["none", "look", "reset"])
def test_camera_fault_is_not_correct(monkeypatch, fault):
    """The driver follows the camera from the events itself: a session
    that turns the wrong way, or keeps accumulating over a move, fails;
    the sound session at the same traffic passes."""
    import importlib
    session = importlib.import_module(SESSION).InteractiveSession
    if fault == "look":
        look = session.look
        monkeypatch.setattr(session, "look",
                            lambda self, dx, dy: look(self, -dx, dy))
    elif fault == "reset":
        def keep_accumulating(self):
            self._packets = None
        monkeypatch.setattr(session, "_dirty", keep_accumulating)
    # A move before every frame: each frame after the warm-up's first
    # follows a pose that already holds a sample.
    res = rehearse("interact.surface500k", seconds=0.5,
                   overrides=dict(traffic=dict(look_every=1)))
    assert res["correct"] == (fault == "none"), res["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    res = rehearse(workload, seconds=0.5)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(workload):
    res = rehearse(workload, seconds=0.5, stand_ins=("lowp",))
    lowp = res["looks"]["lowp"]
    assert any(lowp[k] > c["limit"] for k, c in res["checks"].items()), \
        lowp
