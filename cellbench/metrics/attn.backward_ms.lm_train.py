"""attn.backward_ms.lm_train: the device time of every
``repro_torch.attn.backward`` span (the attention plan's recompute and
backward, once a layer) over the number of ``repro_torch.optim.update``
spans (once a step): ms a training step."""

from cellbench.spans import summary


def read(r):
    attn, update = summary(r, "attn.backward"), summary(r, "optim.update")
    if attn is None or update is None:
        return None
    return 1e3 * attn.device_s / update.count
