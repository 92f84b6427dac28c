"""Multi-process runtime of the port (``distributed``): ranks of one
torch.distributed process group share the samples of ``count`` and the
partitions of ``diff`` over a shared filesystem."""
