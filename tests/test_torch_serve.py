"""The port's continuous batching (engine/serve.py) on the CPU against the
JAX package.

The config, weights, prompts and sizes of tests/test_serve.py, carried
over with params_from_numpy. float32, JAX matmuls at "highest" precision
(conftest.py), TF32 off in torch. The port's ServeEngine must give the JAX
ServeEngine's completions (ids in finish order, tokens, prompt lengths)
and rounds while every draft append fits the JAX frame's 64 headroom
slots; served streams must equal the port's solo streams (also past that
headroom, where a full-budget frame must accept exactly 1.0); and
_install_row must copy a staging row bit for bit and touch no other row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.engine.serve import Request as JRequest
from magicdec_tpu.engine.serve import ServeEngine as JServe
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.models.llama import init_params as j_init
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.serve import Request, ServeEngine
from magicdec_tpu_torch.engine.spec import generate_selfspec
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False

CFG_KW = dict(block_size=512, vocab_size=512, n_layer=2, n_head=4,
              n_kv_head=2, dim=64, intermediate_size=128)
JCFG, TCFG = JArgs(**CFG_KW), TArgs(**CFG_KW)
PREFIX, BUDGET, GAMMA = 64, 32, 3
MAX_LEN = 256
NEW_LENS = [10, 17, 24, 8, 15]
KW = dict(batch_size=2, max_len=MAX_LEN, draft_budget=BUDGET, gamma=GAMMA,
          prefill_chunk=32)


@pytest.fixture(scope="module")
def jparams():
    return j_init(jax.random.PRNGKey(0), JCFG, jnp.float32, scale=0.5)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, JCFG.vocab_size, size=(PREFIX,)).astype(np.int32)
            for _ in range(5)]


def _solo(tparams, prompt, max_new, budget=BUDGET, max_len=MAX_LEN):
    """The stream the port's standalone engine emits for this prompt."""
    eng = TEngine(TCFG, tparams, batch_size=1, max_len=max_len,
                  prefill_chunk=32, spec="snapkv", draft_budget=budget,
                  device="cpu")
    out, _, _ = generate_selfspec(eng, prompt[None, :], gamma=GAMMA,
                                  max_new_tokens=max_new)
    return out[0, :max_new].numpy()


def _serve(tparams, reqs, **kw):
    srv = ServeEngine(TCFG, tparams, device="cpu", **{**KW, **kw})
    return srv, srv.run(reqs)


def test_serve_matches_jax(jparams, tparams, prompts):
    """5 requests of distinct lengths through a 2-row frame: the port's
    completions and rounds are JAX's (every row recycled; no request
    outgrows the JAX frame's draft headroom at max_new_cap 32)."""
    jsrv = JServe(JCFG, jparams, max_new_cap=32, **KW)
    jdone = jsrv.run([JRequest(i, p, n) for i, (p, n)
                      in enumerate(zip(prompts, NEW_LENS))])
    srv, done = _serve(tparams, [Request(i, p, n) for i, (p, n)
                                 in enumerate(zip(prompts, NEW_LENS))],
                       max_new_cap=32)
    assert [c.req_id for c in done] == [c.req_id for c in jdone]
    for c, jc in zip(done, jdone):
        np.testing.assert_array_equal(c.tokens, jc.tokens)
        assert (c.prompt_len, c.rounds) == (jc.prompt_len, jc.rounds)
    assert srv.rounds == jsrv.rounds
    assert srv.host_reads == srv.rounds and srv.admissions == 5


def test_serve_streams_equal_solo_runs(tparams, prompts):
    reqs = [Request(i, p, n) for i, (p, n) in enumerate(zip(prompts,
                                                            NEW_LENS))]
    _, done = _serve(tparams, reqs, max_new_cap=32)
    assert sorted(c.req_id for c in done) == list(range(5))
    for c in done:
        want = _solo(tparams, prompts[c.req_id], NEW_LENS[c.req_id])
        np.testing.assert_array_equal(c.tokens, want)


def test_serve_eot_clips_stream(tparams, prompts):
    """A request whose solo stream holds token X, served with eot X, stops
    at X's first occurrence."""
    solo = _solo(tparams, prompts[0], 24)
    eot_tok = int(solo[5])
    cut = int(np.nonzero(solo == eot_tok)[0][0])
    _, done = _serve(tparams, [Request(0, prompts[0], 24)], max_new_cap=32,
                     eot_ids=(eot_tok,))
    assert len(done) == 1
    np.testing.assert_array_equal(done[0].tokens, solo[:cut + 1])


def test_serve_more_requests_than_frame(tparams, prompts):
    """The frame serves the queue in fewer rounds than 5 sequential solo
    runs take (row recycling overlaps requests)."""
    reqs = [Request(i, p, 12) for i, p in enumerate(prompts)]
    srv, done = _serve(tparams, reqs, max_new_cap=16)
    assert len(done) == 5
    assert srv.rounds < sum(c.rounds for c in done)
    assert 0.5 < srv.occupancy <= 1.0


@pytest.mark.parametrize("budget", [BUDGET, PREFIX])
def test_serve_past_the_draft_headroom(tparams, prompts, budget):
    """max_new_cap 100: a row's draft grows past the JAX frame's 64 headroom
    slots, which the port's frame never drops. Served streams still equal
    the solo streams; at full budget (= the prompt) the frame accepts
    exactly 1.0."""
    new_lens = [100, 70, 90]
    reqs = [Request(i, prompts[i], n) for i, n in enumerate(new_lens)]
    srv, done = _serve(tparams, reqs, max_new_cap=100, max_len=512,
                       draft_budget=budget)
    for c in done:
        want = _solo(tparams, prompts[c.req_id], new_lens[c.req_id],
                     budget=budget, max_len=512)
        np.testing.assert_array_equal(c.tokens, want)
    if budget == PREFIX:
        assert srv.acceptance_rate == 1.0
    else:
        assert 0.0 <= srv.acceptance_rate < 1.0


def test_install_row_copies_the_staging_row_bit_for_bit(tparams, prompts):
    srv = ServeEngine(TCFG, tparams, max_new_cap=32, device="cpu", **KW)
    srv._admit(0, Request(0, prompts[0], 8))
    frame = srv.frame
    before = [t.clone() for t in (frame.cache.k[:, 0], frame.cache.v[:, 0],
                                  frame.draft.k[:, 0], frame.draft.v[:, 0])]
    srv.output[1] = 7              # stale tokens of the row's last tenant
    srv.gen_counts[1] = 5
    srv._admit(1, Request(1, prompts[1], 8))
    st = srv.stage
    sd = st.draft.size
    assert torch.equal(frame.cache.k[:, 1], st.cache.k[:, 0])
    assert torch.equal(frame.cache.v[:, 1], st.cache.v[:, 0])
    assert torch.equal(frame.draft.k[:, 1, :sd], st.draft.k[:, 0])
    assert torch.equal(frame.draft.v[:, 1, :sd], st.draft.v[:, 0])
    assert int(frame.cache.lengths[1]) == PREFIX
    assert int(frame.draft.lengths[1]) == BUDGET
    assert int(frame.draft.evicted[1]) == 0
    assert not srv.output[1].any() and int(srv.gen_counts[1]) == 0
    assert srv.output.shape[1] == 32 + GAMMA + 2 + 1      # the dump column
    for got, want in zip((frame.cache.k[:, 0], frame.cache.v[:, 0],
                          frame.draft.k[:, 0], frame.draft.v[:, 0]), before):
        assert torch.equal(got, want)                     # row 0 untouched
    assert int(frame.cache.lengths[0]) == PREFIX
    with pytest.raises(ValueError, match="max_new_cap"):
        srv._admit(1, Request(2, prompts[2], 33))


def test_frame_draft_grows_for_a_shorter_prompt_and_keeps_live_rows(tparams,
                                                                    prompts):
    """The frame's draft rows are sized to the prompts served: two 96-token
    requests serve two rounds, then a 64-token request arrives and grows the
    draft mid-serve. The live rows keep their draft bytes, and every stream
    still equals its solo stream."""
    rng = np.random.default_rng(5)
    long_ = [rng.integers(0, TCFG.vocab_size, size=(96,)).astype(np.int32)
             for _ in range(2)]
    srv = ServeEngine(TCFG, tparams, max_new_cap=32, device="cpu", **KW)
    first = srv.run([Request(0, long_[0], 20), Request(1, long_[1], 12)],
                    max_rounds=2)
    assert first == [] and srv.frame.draft.size == BUDGET + MAX_LEN - 96
    frame = srv.frame
    keep = frame.draft.k.clone()
    lengths = frame.draft.lengths.clone()
    srv._fit_draft(PREFIX)
    assert frame.draft.size == BUDGET + MAX_LEN - PREFIX
    assert torch.equal(frame.draft.k[:, :, :keep.shape[2]], keep)
    assert torch.equal(frame.draft.lengths, lengths)
    done = first + srv.run([Request(2, prompts[0], 16)])
    want = {0: _solo(tparams, long_[0], 20), 1: _solo(tparams, long_[1], 12),
            2: _solo(tparams, prompts[0], 16)}
    assert sorted(c.req_id for c in done) == [0, 1, 2]
    for c in done:
        np.testing.assert_array_equal(c.tokens, want[c.req_id])
