"""Models: the paper's ResNet for CIFAR, and the dense GQA transformer
family (``config``, ``layers``, ``attention``, ``transformer``)."""
