"""Data parallelism over ``torch.distributed`` (torch twin of
``gan_deeplearning4j_tpu/parallel/``): process groups and collectives
(``mesh``) and ``DataParallelGraph`` (``data_parallel``)."""
