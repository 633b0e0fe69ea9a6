"""KCCOT-GAN in PyTorch for NVIDIA Hopper.

The counterpart of ``kccotgan_tpu``, which stays the reference.  It
imports neither JAX nor the JAX package: ``config`` holds its own copy of
the configuration fields and presets it reads.  Ported so far: the
conditioned rollout (``train.rollout.build_rollout``) with its ConvLSTM
recurrence as a hand-written CUDA kernel (``csrc/convlstm_fwd.cu``), and
the training iteration (``train.steps.build_train_step``) with the fused
Sinkhorn forward and backward as hand-written CUDA kernels
(``csrc/sinkhorn_fwd.cu``, ``csrc/sinkhorn_bwd.cu``).  Its recurrences
run as plain loops under autograd with ``kernel_impl='scan'``, or under
``'pallas'`` through the ConvLSTM forward and backward
(``csrc/convlstm_bwd.cu``) and the dense LSTM forward and backward
(``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``) kernels.  Around the step:
the trainer (``train.loop.Trainer``, ``cli.main``) over the synthetic and
MMNIST data (``data``), with checkpoints for an exact resume (``ckpt``),
PSNR/SSIM of its samples (``eval``) and its logs (``utils``).
"""
