"""Configuration for ravvent_tpu_torch (a copy of ravvent_tpu/config.py).

The reference hard-codes hyperparameters in per-script ``__main__`` blocks and
serializes them into a run-name string that doubles as the checkpoint/log path
schema (reference: ravvent.py:14-31, analysis_utils.py:87-135). Here the same
knobs live in dataclasses; ``RunConfig.run_name`` emits the reference's exact
name schema so experiment bookkeeping stays compatible.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


# Data-shape constants (reference: data_loader.py:12-17).
# The event-detector windows are overridable per process (RAVVENT_ED_W1/W2)
# for per-noise-rung re-fits: on the simulator's noisy rung the default 6/9
# misses ~19% of true base boundaries at +-2 samples while 4/8 recovers
# recall to ~0.91 at the cost of over-segmentation (1.34 events/base) —
# see docs/TRAINING.md (joint-vs-raw investigation). Callers overriding the
# windows must use a dedicated snippet cache dir: the .npz cache is not
# keyed by the detector config.
import os as _os

ED_WINDOW_LENGTH_1 = int(_os.environ.get("RAVVENT_ED_W1", 6))
ED_WINDOW_LENGTH_2 = int(_os.environ.get("RAVVENT_ED_W2", 9))
INPUT_PADDING = 0.0
MAX_RAW_LEN = 200
MAX_EVENT_LEN = 30

# Static target-token length for fixed-shape TPU decoding. The reference pads
# targets to the per-file batch max (data_loader.py:124); on TPU we pad to a
# global static length and mask. Snippets hold <= MAX_EVENT_LEN events
# (~<=MAX_EVENT_LEN+1 bases) plus start/end tokens, so 48 is a safe bound
# (empirically the max is ~36; see tools/event_max_estimation.py).
MAX_TARGET_LEN = 48

EVENT_FEATURES = 5  # (length, mean, stdv, mean^2, delta-mean) data_loader.py:74-79
RAW_FEATURES = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Snippet-pipeline configuration (reference: data_loader.py)."""

    stride: int = 6
    max_raw_len: int = MAX_RAW_LEN
    max_event_len: int = MAX_EVENT_LEN
    max_target_len: int = MAX_TARGET_LEN
    ed_window_length1: int = ED_WINDOW_LENGTH_1
    ed_window_length2: int = ED_WINDOW_LENGTH_2
    input_padding: float = INPUT_PADDING
    batch_size: int = 128
    shuffle: bool = True
    initial_random_seed: int = 0
    size_scaler: float = 1.0
    # Unlike the reference (which re-runs event detection on every file visit,
    # every epoch; data_loader.py:234-240), we cache preprocessed snippets.
    cache_preprocessed: bool = True
    prefetch: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (reference: basecaller.py:158-206)."""

    enc_units: int = 128
    dec_units: int = 128
    encoder_depth: int = 2
    decoder_depth: int = 1
    rnn_type: str = "bilstm"  # {'gru', 'lstm', 'bigru', 'bilstm'}
    attention_type: str = "luong"  # {'luong', 'bahdanau'}
    data_type: str = "joint"  # {'raw', 'event', 'joint'}
    vocab_size: int = 7
    beam_width: int = 5
    # Reference quirk (basecaller.py:194): the Basecaller ctor ignores its
    # attention_type arg and hard-codes Luong. We default to honoring the
    # configured attention but expose the quirk behind this flag.
    force_luong: bool = False

    @property
    def effective_attention(self) -> str:
        return "luong" if self.force_luong else self.attention_type

    @property
    def max_input_len(self) -> int:
        # reference: basecaller.py:180-185
        if self.data_type == "raw":
            return MAX_RAW_LEN
        if self.data_type == "event":
            return MAX_EVENT_LEN
        return MAX_RAW_LEN + MAX_EVENT_LEN

    @property
    def bidirectional(self) -> bool:
        return "bi" in self.rnn_type

    @property
    def cell_type(self) -> str:
        return "lstm" if "lstm" in self.rnn_type else "gru"

    @property
    def enc_out_dim(self) -> int:
        return self.enc_units * (2 if self.bidirectional else 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training configuration (reference: ravvent.py:14-29)."""

    teacher_forcing: float = 0.5  # float => scheduled sampling prob; 1.0/True => full TF
    learning_rate: float = 1e-4
    clipnorm: float = 1.0  # per-variable gradient-norm clip (keras semantics)
    batch_size: int = 128
    epochs: int = 40
    steps_per_epoch: int = 10000
    validation_steps: int = 1500
    random_seed: int = 22
    dataset_tag: str = "lambda"
    checkpoint_dir: str = "models"
    info_dir: str = "info"
    # TPU additions
    num_data_shards: int = 1  # data-parallel mesh size (1 = single chip)
    compute_dtype: str = "float32"  # {'float32', 'bfloat16'} matmul inputs


@dataclasses.dataclass(frozen=True)
class RunConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    @property
    def run_name(self) -> str:
        """Reference-compatible run-name schema (ravvent.py:31)."""
        t = self.train
        m = self.model
        tf_part = (
            str(int(t.teacher_forcing))
            if float(t.teacher_forcing) in (0.0, 1.0)
            else str(round(t.teacher_forcing, 2))
        )
        return (
            f"{m.data_type}.{t.dataset_tag}.mask.pad.lr{round(t.learning_rate, 6)}."
            f"{m.rnn_type}.encu{m.enc_units}.encd{m.encoder_depth}."
            f"decu{m.dec_units}.decd{m.decoder_depth}.b{t.batch_size}."
            f"{m.effective_attention}.tf{tf_part}.strd{self.data.stride}."
            f"spe{t.steps_per_epoch}.spv{t.validation_steps}"
        )

    def checkpoint_path(self, epoch: int) -> str:
        """Reference-compatible checkpoint path schema (ravvent.py:61)."""
        m = self.model
        return (
            f"{self.train.checkpoint_dir}/snippets/mask/"
            f"encd_{m.encoder_depth}_decd_{m.decoder_depth}/"
            f"model.1.{self.run_name}.{epoch:02d}"
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        d = json.loads(s)
        return cls(
            data=DataConfig(**d["data"]),
            model=ModelConfig(**d["model"]),
            train=TrainConfig(**d["train"]),
        )
