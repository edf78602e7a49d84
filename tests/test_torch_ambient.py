"""The port against the JAX package under chip_smoke.py phase 14f's bright
ambient (CPU): ``cli render --backend dense --max-contribs 256`` of
surface_scene(2000) as a 3DGS checkpoint with a sun, through both command
lines. At phase 5's dim ambient the images meet 5b's depth-1 gate; at
ambient 0.6 the two float32 implementations of the reference's math part
on ~10% of the pixels (the thin surfels' alpha rounding, scaled by the
ambient term), and tests/torch_ambient_divergence.py's measured gate holds
them, as it holds the card against the CPU in 14f."""
import pytest
import torch

import torch_ambient_divergence as amb
from torch_parity import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

# 5b's depth-1 gate (chip_smoke.py's PT_MIN_SHARE, PT_MEAN_FRAC).
DIM_MIN_SHARE, DIM_MEAN_FRAC = 0.99, 0.01


@pytest.mark.parametrize("ambient,alpha,min_share,mean_frac", [
    (0.05, 0.0, DIM_MIN_SHARE, DIM_MEAN_FRAC),
    (amb.BRIGHT, 0.0, amb.MIN_SHARE, amb.MAX_MEAN_FRAC),
    (amb.BRIGHT, 180.0, amb.MIN_SHARE, amb.MAX_MEAN_FRAC)],
    ids=["dim", "bright", "bright_alpha180"])
def test_cli_render_matches_under_ambient(tmp_path, ambient, alpha,
                                          min_share, mean_frac):
    got, want = amb.render_both(amb.write_world(str(tmp_path), ambient),
                                str(tmp_path), alpha)
    assert got.shape == want.shape == (64, 96, 3)
    c = amb.compare(got, want)
    print(c)
    assert c["within"] >= min_share and c["mean_frac"] <= mean_frac, c
