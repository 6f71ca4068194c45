"""Training of the port: the spotwise, gridwise and masked-LM trainers,
their Adam, checkpoints, preemption, the background checkpoint writer and
the distillation of f into a fast student."""

from gridnext_tpu_torch.train.async_ckpt import AsyncCheckpointWriter
from gridnext_tpu_torch.train.distill import (distill_patch_classifier, label_agreement,
                                              make_distill_step, patch_agreement,
                                              write_count_distilled_mm_dir,
                                              write_distilled_model_dir)
from gridnext_tpu_torch.train.loops import (OptimizerSpec, TrainState, create_train_state,
                                            load_checkpoint, load_f_params, make_adam,
                                            make_gridwise_optimizer, make_masked_adam,
                                            make_mlm_steps, make_steps,
                                            masked_cross_entropy, mlm_token_len,
                                            restore_train_state, save_checkpoint,
                                            train_gridwise, train_mlm, train_spotwise)
from gridnext_tpu_torch.train.preempt import (TrainingPreempted,
                                              install_preemption_handler)

__all__ = ["AsyncCheckpointWriter", "OptimizerSpec", "TrainState", "TrainingPreempted",
           "create_train_state", "distill_patch_classifier", "install_preemption_handler",
           "label_agreement", "load_checkpoint", "load_f_params", "make_adam",
           "make_distill_step", "make_gridwise_optimizer", "make_masked_adam",
           "make_mlm_steps", "make_steps", "masked_cross_entropy", "mlm_token_len",
           "patch_agreement", "restore_train_state", "save_checkpoint", "train_gridwise",
           "train_mlm", "train_spotwise", "write_count_distilled_mm_dir",
           "write_distilled_model_dir"]
