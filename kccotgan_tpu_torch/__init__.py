"""KCCOT-GAN in PyTorch for NVIDIA Hopper.

The counterpart of ``kccotgan_tpu``, which stays the reference.  It
imports neither JAX nor the JAX package: ``config`` holds its own copy of
the configuration fields and presets it reads.  Ported so far: the
conditioned rollout (``train.rollout.build_rollout``) with its ConvLSTM
recurrence as a hand-written CUDA kernel (``csrc/convlstm_fwd.cu``), and
the training iteration (``train.steps.build_train_step``, recurrences as
plain loops under ``kernel_impl='scan'``) with the fused Sinkhorn forward
and backward as hand-written CUDA kernels (``csrc/sinkhorn_fwd.cu``,
``csrc/sinkhorn_bwd.cu``).
"""
