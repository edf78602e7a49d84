"""The benchmark's plain reference: plain torch and numpy, importing
nothing of the program. It works out the grid, the tile packets, the
light tables and the random numbers again from the benchmark's inputs, and
judges what the program's timed path produced."""
import torch


def plain_precision() -> None:
    """float32 matrix products without TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
