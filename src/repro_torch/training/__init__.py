"""Training substrate: AdamW, the train-step factory and the synthetic data
pipeline (the JAX package's ``training`` exports)."""
from .data import DataConfig, TokenDataset, hash_tokenize
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        cosine_lr)
from .train_loop import batch_to, init_train_state, make_train_step

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_lr", "make_train_step", "init_train_state",
           "TokenDataset", "DataConfig", "hash_tokenize", "batch_to"]
