"""The model SDK: the contract templates implement (``sdk/model.py``), the
training backend (``sdk/torch_backend.py``, ``sdk/population.py``), knob
types, dataset utilities, parameter serialization and the in-model
logger, exported here as ``rafiki_tpu/sdk/__init__.py`` exports them."""

from rafiki_tpu_torch.sdk.dataset import dataset_utils  # noqa: F401
from rafiki_tpu_torch.sdk.knob import (  # noqa: F401
    BaseKnob,
    CategoricalKnob,
    FixedKnob,
    FloatKnob,
    IntegerKnob,
    deserialize_knob_config,
    serialize_knob_config,
)
from rafiki_tpu_torch.sdk.log import (  # noqa: F401
    ModelLogger,
    StopTrialEarly,
    logger,
    parse_logs,
)
from rafiki_tpu_torch.sdk.model import (  # noqa: F401
    BaseModel,
    GenerationSpec,
    InvalidModelClassError,
    PopulationSpec,
    draft_capability,
    generation_capability,
    load_model_class,
    population_capability,
    sampling_capability,
    spec_verify_capability,
    validate_model_dependencies,
)
from rafiki_tpu_torch.sdk.params import dump_params, load_params  # noqa: F401
from rafiki_tpu_torch.sdk.population import PopulationTrainer  # noqa: F401
from rafiki_tpu_torch.sdk.torch_backend import (  # noqa: F401
    DataParallelTrainer,
    cached_trainer,
    classification_accuracy,
    softmax_classifier_loss,
    trainer_ensemble_stack,
    tunable_optimizer,
)
