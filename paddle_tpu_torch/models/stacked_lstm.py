"""Stacked-LSTM text classifier — a copy of
``paddle_tpu/models/stacked_lstm.py`` (the book/06 understand_sentiment
recipe, measured by ``benchmark/fluid/stacked_dynamic_lstm.py``):
embedding → fc → N × (fc + ``dynamic_lstm``, directions alternating) →
max-pooled states → softmax. The ids are a ragged (``lod_level=1``) feed;
``dynamic_lstm(size=hid_dim)`` is ``hid_dim / 4`` wide, as there.
"""

from .. import layers

__all__ = ["stacked_lstm_net"]


def stacked_lstm_net(data, dict_dim, class_dim=2, emb_dim=128, hid_dim=512,
                     stacked_num=3):
    assert stacked_num % 2 == 1
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])

    fc1 = layers.fc(input=emb, size=hid_dim)
    lstm1, cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim)

    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim)
        lstm, cell = layers.dynamic_lstm(
            input=fc, size=hid_dim, is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")
    prediction = layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act="softmax")
    return prediction
