"""Multi-device rendering and training over torch.distributed (port of
tungsten_tpu/parallel/)."""
