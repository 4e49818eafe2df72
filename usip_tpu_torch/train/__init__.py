"""Training: the train state, the detector's siamese train/eval steps and
the descriptor's train step."""

from usip_tpu_torch.train.state import (TrainState, lr_at_epoch, make_adam,
                                        set_learning_rate)
from usip_tpu_torch.train.steps import (DescriptorBatch, DescriptorDraws,
                                        DetectorBatch, DetectorDraws,
                                        PackedPairBatch, ParentBatch,
                                        make_descriptor_train_step,
                                        make_detector_eval_step,
                                        make_detector_loss_fn,
                                        make_detector_train_step,
                                        pack_pair_batch)

__all__ = ["DescriptorBatch", "DescriptorDraws", "DetectorBatch",
           "DetectorDraws", "PackedPairBatch", "ParentBatch", "TrainState",
           "lr_at_epoch", "make_adam", "make_descriptor_train_step",
           "make_detector_eval_step", "make_detector_loss_fn",
           "make_detector_train_step", "pack_pair_batch",
           "set_learning_rate"]
