"""The frozen generator against the program's, and what a seed changes."""
import numpy as np
import pytest

from ragbench import tiny, traffic
from repro_torch.retrieval import corpus as port


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_frozen_generator_equals_the_programs(seed):
    a = traffic.make_corpus(50, 16, 64, vocab=300, seed=seed)
    b = port.make_corpus(50, 16, 64, vocab=300, seed=seed)
    np.testing.assert_array_equal(a.doc_vectors, b.doc_vectors)
    np.testing.assert_array_equal(a.doc_lengths, b.doc_lengths)
    for x, y in zip(a.doc_tokens, b.doc_tokens):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(traffic.zipf_popularity(50, 1.0, seed),
                                  port.zipf_popularity(50, 1.0, seed))
    kw = dict(n_requests=40, rate=9.0, zipf_s=1.0, question_tokens=8,
              output_len_mean=6, query_noise=0.02, vocab=300, seed=seed + 1)
    for r, s in zip(traffic.make_workload(a, **kw),
                    port.make_workload(b, **kw)):
        assert (r.req_id, r.arrival, r.target_doc, r.output_len) == \
            (s.req_id, s.arrival, s.target_doc, s.output_len)
        np.testing.assert_array_equal(r.query_vec, s.query_vec)
        np.testing.assert_array_equal(r.question_tokens, s.question_tokens)


def test_seeds_share_requests_and_arrivals_and_differ_in_tokens():
    t = dict(tiny.TRAFFIC)
    one = traffic.build(t, 3, 5.0, 8.0, 512, n_warmup=10)
    two = traffic.build(t, 2**33 + 1, 5.0, 8.0, 512, n_warmup=10)
    for tr in (one, two):
        due = [r.arrival for r in tr.window]
        assert len(due) == 40 and due == sorted(due)
        assert 0 <= due[0] and due[-1] < 5.0
        assert len(tr.warmup) == 10
        assert all(len(r.question_tokens) == 8 for r in tr.window)
    np.testing.assert_array_equal(one.corpus.doc_lengths,
                                  two.corpus.doc_lengths)
    np.testing.assert_array_equal(one.corpus.doc_vectors,
                                  two.corpus.doc_vectors)
    # the same requests, in the same order, at the same due times
    for a, b in zip(one.window + one.warmup, two.window + two.warmup):
        assert (a.req_id, a.arrival, a.target_doc, a.output_len) == \
            (b.req_id, b.arrival, b.target_doc, b.output_len)
        np.testing.assert_array_equal(a.query_vec, b.query_vec)
    assert len({r.target_doc for r in one.window}) > 1
    # the seed draws the tokens
    assert not np.array_equal(one.corpus.doc_tokens[0],
                              two.corpus.doc_tokens[0])
    assert not np.array_equal(one.window[0].question_tokens,
                              two.window[0].question_tokens)


def test_same_seed_same_inputs():
    t = dict(tiny.TRAFFIC)
    a = traffic.build(t, 12, 3.0, 10.0, 512, n_warmup=4)
    b = traffic.build(t, 12, 3.0, 10.0, 512, n_warmup=4)
    for r, s in zip(a.window + a.warmup, b.window + b.warmup):
        assert (r.arrival, r.target_doc) == (s.arrival, s.target_doc)
        np.testing.assert_array_equal(r.query_vec, s.query_vec)
        np.testing.assert_array_equal(r.question_tokens, s.question_tokens)
