"""optim.update_ms.lm_train: the median device time of the port's
``repro_torch.optim.update`` span (clipping and the AdamW update, once a
training step), in ms."""

from cellbench.spans import median_ms


def read(r):
    return median_ms(r, "optim.update", "device")
