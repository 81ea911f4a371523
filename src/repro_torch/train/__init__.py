from repro_torch.train.step import (TrainSettings, TrainState,
                                    make_decode_step, make_prefill_step,
                                    make_train_step)

__all__ = ["TrainSettings", "TrainState", "make_decode_step",
           "make_prefill_step", "make_train_step"]
