"""The dry run's input shapes (the reference's ``configs/shapes.py``):
sequence length x global batch of each LM cell.

``train_*`` runs the train step, ``prefill_*`` the prefill step,
``decode_*`` and ``long_*`` one new token against a cache of
``seq_len`` positions (``launch/dryrun.py``).
"""
from repro_torch.configs.base import ShapeConfig

SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                               kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind="decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
