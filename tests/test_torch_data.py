"""The port's data streams (``repro_torch.data``) against the reference's
``repro.data``: every batch bitwise equal for the same seed and step, the
cursor's state round-trips, and the tokenizer encodes and decodes alike."""
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.data import tasks as jtasks
from repro.data import tokenizer as jtok
from repro_torch import configs as pconfigs
from repro_torch.data import pipeline as ppipe
from repro_torch.data import tasks as ptasks
from repro_torch.data import tokenizer as ptok


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, seq_len=16, batch_size=4, seed=0),
    dict(vocab_size=49152, seq_len=128, batch_size=8, seed=0),
    dict(vocab_size=259, seq_len=33, batch_size=3, seed=7, shard_id=1,
         num_shards=2, branching=2)])
def test_lm_stream_batches_bitwise(kw):
    a, b = jpipe.LMStream(**kw), ppipe.LMStream(**kw)
    for _ in range(4):
        _equal(a.next(), b.next())
    assert a.state() == b.state()


def test_lm_stream_state_round_trips():
    kw = dict(vocab_size=128, seq_len=16, batch_size=4, seed=5)
    s = ppipe.LMStream(**kw)
    for _ in range(3):
        s.next()
    state = s.state()
    want = s.next()
    fresh = ppipe.LMStream(**kw)
    fresh.restore(state)
    _equal(fresh.next(), want)
    ref = jpipe.LMStream(**kw)
    ref.restore(state)          # the reference resumes from the port's cursor
    _equal(ref.next(), want)
    with pytest.raises(ValueError, match="different stream"):
        ppipe.LMStream(**dict(kw, seed=6)).restore(state)


@pytest.mark.parametrize("kw", [
    dict(name="t", vocab_size=128, seq_len=16, num_classes=2, seed=3),
    dict(name="t", vocab_size=49152, seq_len=64, num_classes=2, seed=3),
    dict(name="t", vocab_size=300, seq_len=40, num_classes=4, seed=11,
         keywords_per_class=5, signal_tokens=3)])
def test_classification_batches_bitwise(kw):
    a, b = jtasks.ClassificationTask(**kw), ptasks.ClassificationTask(**kw)
    np.testing.assert_array_equal(a.keywords, b.keywords)
    for step in (0, 1, 1_000_000):
        _equal(a.batch(16, step), b.batch(16, step))


def test_task_suite_and_input_batch_equal():
    for a, b in zip(jtasks.make_task_suite(128), ptasks.make_task_suite(128)):
        assert (a.name, a.seed, a.num_classes) == (b.name, b.seed,
                                                   b.num_classes)
        _equal(a.batch(4, 2), b.batch(4, 2))
    jcfg = jconfigs.reduced(jconfigs.get("smollm-360m"), repeats=2)
    pcfg = pconfigs.reduced(pconfigs.get("smollm-360m"), repeats=2)
    for js, ps in zip(jcfg.shapes, pcfg.shapes):
        _equal(jpipe.input_batch_for(jcfg, js, seed=4),
               ppipe.input_batch_for(pcfg, ps, seed=4))


@pytest.mark.parametrize("text", ["", "hello", "héllo wörld ✓"])
def test_byte_tokenizer_equal(text):
    a, b = jtok.ByteTokenizer(), ptok.ByteTokenizer()
    for bos, eos in ((True, False), (False, True)):
        ids = a.encode(text, bos, eos)
        assert b.encode(text, bos, eos) == ids
        assert b.decode(ids) == a.decode(ids) == text
    assert (b.vocab_size, b.pad_id, b.bos_id, b.eos_id) == (
        a.vocab_size, a.pad_id, a.bos_id, a.eos_id)
