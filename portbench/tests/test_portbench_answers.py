"""The window's answer slots: filled in order, and an answer that does not
fit a slot is still kept."""

import torch

from portbench.harness import Answers


def test_answers_fill_slots_then_fall_back():
    ids = torch.arange(6).reshape(2, 3)
    dists = torch.rand(2, 3)
    ans = Answers(ids, dists, capacity=2, cuda=False)
    got = [ans.fetch(ids + i, dists + i) for i in range(3)]
    assert ans.used == 2
    for i, (hi, hd) in enumerate(got):
        assert torch.equal(hi, ids + i) and torch.equal(hd, dists + i)
    # the first two live in the slots, the third past them is a copy
    assert got[0][0].data_ptr() == ans.ids[0].data_ptr()
    assert got[2][0].data_ptr() != ans.ids[1].data_ptr()


def test_answer_of_another_shape_is_kept_as_it_is():
    ids, dists = torch.zeros(4, 2, dtype=torch.int64), torch.zeros(4, 2)
    ans = Answers(ids, dists, capacity=3, cuda=False)
    hi, hd = ans.fetch(ids[:2], dists[:2])
    assert hi.shape == (2, 2) and ans.used == 0
    hi, hd = ans.fetch(ids.int(), dists)
    assert hi.dtype == torch.int32 and ans.used == 0
