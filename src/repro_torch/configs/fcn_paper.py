"""The paper's §VI-C fully connected networks (Table IX), at their
published widths."""

from repro_torch.models.fcn import FCNConfig

MNIST_FCNS = {
    2: FCNConfig("mnist-2h", 784, 10, (2048, 1024)),
    3: FCNConfig("mnist-3h", 784, 10, (2048, 2048, 1024)),
    4: FCNConfig("mnist-4h", 784, 10, (2048, 2048, 2048, 1024)),
}

SYNTHETIC_FCNS = {
    2: FCNConfig("synthetic-2h", 26752, 26752, (4096, 4096)),
    3: FCNConfig("synthetic-3h", 26752, 26752, (4096, 4096, 4096)),
    4: FCNConfig("synthetic-4h", 26752, 26752, (4096, 4096, 4096, 4096)),
}

# paper's tested mini-batch sizes (Figs. 7-8)
MNIST_BATCHES = (128, 256, 512, 1024, 2048, 4096)
SYNTHETIC_BATCHES = (128, 256, 512, 1024, 2048, 4096)
