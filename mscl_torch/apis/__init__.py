from .flagship import (FLAGSHIP_AUG, FLAGSHIP_CONFIG, flagship_batch,
                       flagship_model_cfg, load_flagship_config,
                       narrow_flagship_cfg)
from ..core import to_torch
from .inference import (extract_features, inference_recognizer,
                        init_recognizer, make_eval_fn, make_feature_fn,
                        retrieval_recall, run_test)
from .train import (MOCO_FREEZE, apply_ssl_pretrain, build_model_from_cfg,
                    resolve_device, train_model)

__all__ = ['FLAGSHIP_AUG', 'FLAGSHIP_CONFIG', 'flagship_batch',
           'flagship_model_cfg', 'load_flagship_config', 'narrow_flagship_cfg',
           'MOCO_FREEZE', 'apply_ssl_pretrain', 'build_model_from_cfg',
           'resolve_device', 'to_torch', 'train_model', 'make_eval_fn',
           'make_feature_fn', 'run_test', 'extract_features',
           'retrieval_recall', 'init_recognizer', 'inference_recognizer']
