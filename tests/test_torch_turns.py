"""tools/turns.py on the CPU: the turn order's report, which holds every
checkout's outputs to one digest a shape, and the shape sets --kernel
chooses among (the workers themselves need the card)."""
import pytest

from pathtracer_gaussiansplatting_tpu_torch.tools import turns


def _runs(digests):
    """Two checkouts in turns (A B B A) on one shape and on one input row."""
    shape = {c: [dict(label="s", digest=d, ms=1.0 + i, path="cluster")
                 for i, d in enumerate(ds)]
             for c, ds in zip(("a", "b"), digests)}
    inputs = {c: [dict(label="in", digest="x")] for c in ("a", "b")}
    return {"in": inputs, "s": shape}


@pytest.mark.parametrize("digests, same", [
    ((("d1", "d1"), ("d1", "d1")), True),
    ((("d1", "d1"), ("d2", "d2")), False),
    ((("d1", "d1"), ("d1", "d2")), False),
])
def test_report_holds_checkouts_to_one_digest(capsys, digests, same):
    assert turns._report(_runs(digests), 5, "card") is same
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "in: equal between the checkouts"
    assert out[1].startswith("s: a 1.0000, 2.0000 ms, path cluster; b ")
    assert ("outputs equal" if same else "outputs DIFFER") in out[1]


def test_kernel_chooses_a_shape_set():
    assert sorted(turns.SHAPES) == ["dense_topk", "grid_march", "tile_any"]
    assert sorted(turns.ITERS) == sorted(turns.SHAPES)
    with pytest.raises(SystemExit):
        turns.main(["--kernel", "no_such_kernel"])
