"""PyTorch port: ``beam_search``, ``beam_search_decode``,
``coalesce_tensor``, ``squared_l2_norm``, the 1.x ``lookup_table`` and
``reshape2_grad`` against the JAX lowerings.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every input gradient compared
(``test_torch_lowerings.check_case``), 1e-5 absolute plus 1e-5
relative (float32 on both sides; the integer outputs, ids and parents,
must be equal).

Edge cases: ``beam_search`` with a finished lane (it competes with one
``end_id`` candidate at its frozen score) and with scores tied across
the top-k boundary (the lower flat index wins, as under ``lax.top_k``);
``lookup_table`` with ``padding_idx`` (zero rows, zero gradient) and a
row-sharded table, which raises naming ROADMAP item 8.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tpkg
from paddle_tpu_torch.framework import program as tprogram
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case

BEAM, END = 3, 4


def _beam_inputs(rs):
    pre_ids = np.array([[1], [END], [2], [0], [END], [1]], "int64")
    pre_scores = -np.abs(randn(rs, 6, 1))
    scores = -np.abs(randn(rs, 6, 5)) - 3.0
    # batch 0: -0.5, then -2.0 three times (row 0 cols 1, 2 and row 2
    # col 0); the top 3 take the two lowest flat indices of the tie.
    # Rows 1 and 4 are finished: the only candidate of each is END at
    # its pre_score; row 4's (-0.25) leads batch 1.
    pre_scores[1], pre_scores[4] = -3.0, -0.25
    scores[0, :3] = [-0.5, -2.0, -2.0]
    scores[2, 0] = -2.0
    return pre_ids, pre_scores, scores


def _cases():
    rs = np.random.RandomState(0)
    pre_ids, pre_scores, scores = _beam_inputs(rs)
    ids = rs.randint(0, 50, (6, 5)).astype("int64")
    t, bk = 4, 6
    step_ids = rs.randint(0, 9, (t, bk)).astype("int64")
    parents = (np.arange(bk) // BEAM * BEAM
               + rs.randint(0, BEAM, (t, bk))).astype("int64")
    table = randn(rs, 10, 4)
    v1_ids = rs.randint(0, 10, (2, 3, 1)).astype("int64")
    v1_ids[0, 0, 0] = 3
    beam_outs = ["selected_ids", "selected_scores", "parent_idx"]
    return {
        "beam_search_accumulated": case(
            "beam_search", dict(pre_ids=[pre_ids], pre_scores=[pre_scores],
                                scores=[scores]), beam_outs,
            dict(beam_size=BEAM, end_id=END, is_accumulated=True),
            grad=["selected_scores"]),
        "beam_search_probs_ids": case(
            "beam_search", dict(pre_ids=[pre_ids], pre_scores=[pre_scores],
                                scores=[np.exp(scores)], ids=[ids]),
            beam_outs, dict(beam_size=BEAM, end_id=END, is_accumulated=False),
            grad=["selected_scores"]),
        "beam_search_decode": case(
            "beam_search_decode", dict(Ids=[step_ids], ParentIdx=[parents],
                                       Scores=[randn(rs, t, bk)]),
            ["SentenceIds", "SentenceScores"], dict(beam_size=BEAM),
            grad=["SentenceScores"]),
        "coalesce_tensor": case(
            "coalesce_tensor", dict(Input=[randn(rs, 2, 3), randn(rs, 4),
                                           randn(rs, 1, 2, 2)]),
            [("Output", 3), "FusedOutput"], grad=[]),
        "squared_l2_norm": case("squared_l2_norm", dict(X=[randn(rs, 3, 4)]),
                                ["Out"]),
        "lookup_table_v1": case(
            "lookup_table", dict(W=[table], Ids=[v1_ids]), ["Out"],
            dict(padding_idx=-1, is_sparse=False)),
        "lookup_table_v1_padding_idx": case(
            "lookup_table", dict(W=[table], Ids=[v1_ids]), ["Out"],
            dict(padding_idx=3, is_sparse=False)),
        "reshape2_grad": case(
            "reshape2_grad", {"Out@GRAD": [randn(rs, 6, 4)],
                              "XShape": [np.zeros((0, 2, 3, 4), "f4")]},
            ["X@GRAD"], grad=[]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_misc_lowering_matches_jax(name):
    pairs = check_case(name, CASES[name])
    if name == "beam_search_accumulated":
        sel = pairs["out_selected_scores"][0][:, 0]
        parent = pairs["out_parent_idx"][0]
        ids = pairs["out_selected_ids"][0][:, 0]
        np.testing.assert_array_equal(sel[:3], [-0.5, -2.0, -2.0])
        np.testing.assert_array_equal(parent[:3], [0, 0, 0])
        np.testing.assert_array_equal(ids[:3], [0, 1, 2])
        assert (sel[3], parent[3], ids[3]) == (-0.25, 4, END)
    if name == "lookup_table_v1_padding_idx":
        out = pairs["out_out"][0]
        assert out.shape == (2, 3, 4) and (out[0, 0] == 0).all()
        grad_w = pairs["w_0@GRAD"][0]
        assert (grad_w[3] == 0).all()
    if name == "coalesce_tensor":
        fused = pairs["out_fusedoutput"][0]
        parts = [a.reshape(-1) for a in CASES[name]["inputs"]["Input"]]
        np.testing.assert_array_equal(fused, np.concatenate(parts))


def test_lookup_table_on_a_sharded_table_raises():
    """A table the sharding plan split by rows needs several processes."""
    prog = tprogram.Program()
    blk = prog.global_block
    blk.create_var(name="w", shape=(8, 4), dtype="float32")
    blk.create_var(name="ids", shape=(2, 1), dtype="int64")
    blk.create_var(name="out")
    blk.append_op("lookup_table", {"W": ["w"], "Ids": ["ids"]},
                  {"Out": ["out"]}, {"__emb_row_sharded__": 2})
    with pytest.raises(NotImplementedError, match="item 8"):
        tpkg.Executor(tpkg.CPUPlace()).run(
            prog, feed={"w": np.zeros((8, 4), "f4"),
                        "ids": np.zeros((2, 1), "int64")},
            fetch_list=["out"], scope=tpkg.framework.Scope())
