"""Models: the paper's ResNet for CIFAR."""
