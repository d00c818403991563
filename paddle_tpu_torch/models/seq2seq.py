"""Encoder-decoder NMT model — a copy of ``paddle_tpu/models/seq2seq.py``
(the book/08 machine-translation recipe, reference
``benchmark/fluid/machine_translation.py``): embedding + bidirectional
LSTM encoder, a teacher-forced LSTM decoder booted from the encoder's
last step, a projection to the target vocabulary per step. Source and
target are ragged (``lod_level=1``); decode-time beam search is not
ported.
"""

from .. import layers

__all__ = ["seq2seq_net"]


def encoder(src_word_ids, src_dict_size, embedding_dim=512, encoder_size=512,
            is_sparse=False):
    emb = layers.embedding(input=src_word_ids,
                           size=[src_dict_size, embedding_dim],
                           is_sparse=is_sparse)
    fc_fwd = layers.fc(input=emb, size=encoder_size * 4, act="tanh")
    lstm_fwd, _ = layers.dynamic_lstm(input=fc_fwd, size=encoder_size * 4)
    fc_bwd = layers.fc(input=emb, size=encoder_size * 4, act="tanh")
    lstm_bwd, _ = layers.dynamic_lstm(input=fc_bwd, size=encoder_size * 4,
                                      is_reverse=True)
    bidirect = layers.concat(input=[lstm_fwd, lstm_bwd], axis=1)
    encoded = layers.fc(input=bidirect, size=encoder_size, act="tanh")
    return encoded


def seq2seq_net(src_word_ids, trg_word_ids, src_dict_size, trg_dict_size,
                embedding_dim=512, encoder_size=512, decoder_size=512,
                with_softmax=True, is_sparse=False):
    """Per-step target-vocab predictions as a ragged batch (padded
    ``[batch, max_trg_len, trg_dict]`` + lengths). ``with_softmax=False``
    returns the logits, for ``softmax_with_cross_entropy``.
    ``is_sparse=True`` (SelectedRows embedding grads) is not ported: its
    grad op raises."""
    encoded = encoder(src_word_ids, src_dict_size, embedding_dim,
                      encoder_size, is_sparse=is_sparse)
    enc_last = layers.sequence_last_step(input=encoded)
    dec_h0 = layers.fc(input=enc_last, size=decoder_size, act="tanh")

    trg_emb = layers.embedding(input=trg_word_ids,
                               size=[trg_dict_size, embedding_dim],
                               is_sparse=is_sparse)
    dec_in = layers.fc(input=trg_emb, size=decoder_size * 4, act="tanh")
    dec_out, _ = layers.dynamic_lstm(input=dec_in, size=decoder_size * 4,
                                     h_0=dec_h0)
    prediction = layers.fc(input=dec_out, size=trg_dict_size,
                           act="softmax" if with_softmax else None)
    return prediction
