"""The reference's examples on the port (counterpart of the repo's
``examples/``): the MLP through the binding-compat API
(:mod:`~multiverso_tpu_torch.examples.mlp_cifar`), the data-parallel ResNet
(:mod:`~multiverso_tpu_torch.examples.resnet_imagenet`) and the pipelined
MLP (:mod:`~multiverso_tpu_torch.examples.pipeline_mlp`). Each runs as
``python -m multiverso_tpu_torch.examples.<name>``, on the CUDA devices
unless ``-device`` names another."""
