"""LibriSpeech-shaped synthetic recipe smoke test (reference protocol
shape: egs/librispeech/s5 fbank → NN → lattice decode → LM rescoring;
CTC variant per aslp_scripts/ctc/).  Small configuration — asserts the
whole chain runs and the decode clearly beats chance, not parity
numbers (the full-size run is recipes/ls_synth.py's __main__)."""

import pytest

from kaldi_aslp_tpu.recipes.ls_synth import run


@pytest.mark.slow
def test_ls_synth_pipeline(tmp_path):
    out = run(str(tmp_path / "ls"), num_words=20, num_train=48,
              num_test=8, layers=1, proj=32, cell=48, num_streams=8,
              max_iters=45, rescore_text_mult=8, lm_text_mult=4,
              bucket_t=128,
              max_len=4, lattice_beam=4.0, learn_rate=0.06,
              keep_lr=45)
    assert out["rtf"] > 0
    assert out["wer_small"] < 60.0      # chance is ~100% on 20 words
    assert out["wer_large"] < 60.0
    assert out["train_speed"] > 0
