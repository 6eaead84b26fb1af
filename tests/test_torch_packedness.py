"""The packedness pass (``repro_torch.analysis.packedness``) on the
reference's own cases (``tests/test_analysis.py``): it passes the
sanctioned int32 bridge into the BN-sign pack, catches a seeded escape
with its producer and consumer, launders int -> float only under
``float-residual``, and finds no escape on the BCNN, the BMLP and the
LM.  Words are int32 in the port, so classes come from producers."""
import json

import pytest
import torch

from repro_torch.analysis import graph
from repro_torch.analysis import packedness as P
from repro_torch.analysis import report as TREPORT
from repro_torch.kernels import ops


def _gemm(a, b):
    return ops.binary_matmul_packed(a, b, k_true=256, backend="cuda")


def _packed(m, n, kw=8):
    return ({"w_packed": torch.zeros((m, kw), dtype=torch.int32)},
            {"w_packed": torch.zeros((n, kw), dtype=torch.int32)})


def test_epilogue_bridge_is_clean():
    """The int32 GEMM output into the standalone BN-sign pack is the
    sanctioned unpacked crossing.  The peak live unpacked bytes are the
    bridge alone, 16·128·4: the reference's extra 16·4096·4 is its Pallas
    lane-padded repack staging array, which K2 does not have."""
    def legal(a, b, tau, flip):
        y = _gemm(a["w_packed"], b["w_packed"])
        return ops.bn_sign_pack(y, tau, flip, backend="cuda")

    a, b = _packed(16, 128)
    rep = P.analyze_packedness(legal, a, b, torch.zeros(128),
                               torch.ones(128), policy="strict")
    assert rep.complete and not rep.escapes and rep.ok
    assert rep.launch_count == 2
    assert rep.hbm_values.get("unpacked", 0) >= 1
    assert rep.hbm_values["packed"] == 3      # both operands, the result
    assert rep.max_live_unpacked_bytes == 16 * 128 * 4
    assert rep.max_unpacked_shape == (16, 128)


def _leaky(a, b):
    y = _gemm(a["w_packed"], b["w_packed"])
    s = torch.where(y >= 0, 1.0, -1.0).to(torch.float32)
    return ops.bitpack(s, backend="cuda")


def test_seeded_escape_is_caught():
    """Host-side re-binarization of K4's int32 output fed back through
    K5: the leak the pass exists for."""
    rep = P.analyze_packedness(_leaky, *_packed(16, 128), policy="strict")
    assert not rep.ok and len(rep.escapes) == 1
    esc = rep.escapes[0]
    assert (esc.producer, esc.consumer) == ("xnor_gemm", "bitpack")
    assert esc.shape == (16, 128) and esc.dtype == "int32"
    assert "xnor_gemm -> bitpack" in rep.to_json()["escapes"][0]


def test_float_residual_policy_launders():
    def residual(a, b):
        y = _gemm(a["w_packed"], b["w_packed"]).to(torch.float32)
        return ops.bitpack(y, backend="cuda")

    args = _packed(16, 128)
    assert P.analyze_packedness(residual, *args, policy="strict").escapes
    rep = P.analyze_packedness(residual, *args, policy="float-residual")
    assert not rep.escapes and rep.complete
    # the LM's policy trusts its float stream: the seeded leak's sign to
    # float launders it too
    assert P.analyze_packedness(_leaky, *args,
                                policy="float-residual").ok
    assert P.model_policy("transformer") == "float-residual"
    assert P.model_policy("bcnn") == P.model_policy("bmlp") == "strict"


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="policy"):
        P.analyze_packedness(_gemm, torch.zeros(8, 8, dtype=torch.int32),
                             torch.zeros(8, 8, dtype=torch.int32),
                             policy="lenient")


def test_packed_words_keep_their_class_through_layout_and_pooling():
    """Views, cat and the bit-domain pool of packed words stay packed:
    the BCNN's pooled stage feeds K3 with no unpacked value between."""
    packed = TREPORT.demo_packed("bcnn")
    tr = graph.trace(TREPORT.cuda_forward, packed,
                     TREPORT.forward_input(packed, 8))
    w = P._Walker(tr, "strict")
    w.run()
    conv = [op for op in tr.ops if op.kernel == "conv_bn_sign"][0]
    assert w.cls[conv.inputs[0]] == "packed"
    stack = [op for op in tr.ops if op.kernel == "dense_stack"][0]
    assert w.cls[stack.inputs[0]] == "packed"


@pytest.mark.parametrize("kind", ["bmlp", "bcnn", "transformer"])
def test_no_escape_on_the_forwards(kind):
    rep = json.loads(json.dumps(TREPORT.packedness_cell(kind)))
    assert rep["escapes"] == [] and rep["complete"]
    assert rep["policy"] == P.model_policy(kind)
    # the launch counts the reference's baseline records, less the
    # launches the port merges (test_torch_analysis_graph.py)
    with open(f"{TREPORT.repo_root()}/experiments/ANALYSIS_baseline.json") \
            as f:
        ref = json.load(f)["cells"][f"packedness/{kind}"]
    merged = {"bmlp": 14, "bcnn": 1, "transformer": 0}[kind]
    assert rep["launch_count"] == ref["launch_count"] - merged
    assert ref["escapes"] == []


def test_bmlp_unpacked_values_are_its_accumulators():
    """The BMLP's unpacked values are K4's int32 outputs (the stacked
    bit-plane products and the logits) and the plane recombination
    between the first K4 and K2: at batch 8 the largest is the first
    layer's (8·8, 256) int32 output."""
    rep = TREPORT.packedness_cell("bmlp")
    assert rep["max_unpacked_shape"] == [64, 256]
    assert rep["hbm_bytes"]["unpacked"] == 64 * 256 * 4
