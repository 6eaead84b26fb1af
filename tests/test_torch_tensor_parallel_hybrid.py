"""Tensor parallelism over ``model`` in the port's sharded train step on
the configs with RG-LRU and cross-attention blocks, against the
reference's unsharded step with ``microbatches = data``, within
``tests/_train.py``'s contract (``test_torch_tensor_parallel.py`` holds
the dense and MoE configs, and says what is held).

Reduced recurrentgemma-9b is MQA (1 KV head): its attention falls back
to the whole-weight gather on every mesh, while its RG-LRU width (64)
and FFN (128) split over 2 and 4 positions; the conv output is gathered
over ``model`` (``sharding.tp_gathers``), beside the loss's partial
log-sum-exps, which every mesh here gathers twice a chunk (both
vocabularies of 256 split over 2 and 4 positions): the blocks' share
is the count less the vocabulary's (``_tensor_parallel.block_share``).
Reduced whisper-base (4 query heads over 2 KV heads) splits its
encoder's and decoder's attention, the decoder's cross-attention (the
encoder output fanned out to the positions) and both FFNs over 2
positions; over 4 only the FFNs.
"""
import pytest
import torch

from _tensor_parallel import MESHES, block_share, \
    check_no_whole_model_gather, one_thread, tp_step
from _train import assert_step_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["recurrentgemma-9b", "whisper-base"])
def test_tp_step_equals_the_reference(name, shape):
    jout, tout, lr, got, want, seen = tp_step(name, "float", shape)
    assert_step_close(jout, tout, lr)
    assert got == want
    blocks = block_share(name, shape, got)
    assert blocks["sharding.tp_reduces"] > 0
    assert blocks["sharding.tp_grad_reduces"] > 0
    assert (blocks["sharding.tp_gathers"] > 0) == \
        (name == "recurrentgemma-9b")
    check_no_whole_model_gather(name, shape, seen)
