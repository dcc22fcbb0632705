from .gpt2 import (  # noqa: F401
    GPT2Config, GPT2Model,
    GPT2_SMALL, GPT2_MEDIUM, GPT2_LARGE, GPT2_XL,
    params_from_numpy,
)
from .bert import BertConfig, BertModel, BERT_BASE, BERT_LARGE  # noqa: F401
