"""``paddle.text``-role namespace of the port: the NLP datasets
(``datasets``: UCIHousing, Imdb, Imikolov, read from local files),
greedy and beam-search decoding (``decode``) and the static-graph BERT
builders (``static_models``, a copy of the JAX package's).  Counterpart
of ``paddle_tpu/text/__init__.py``."""
from . import datasets  # noqa: F401
from . import decode  # noqa: F401
from . import static_models  # noqa: F401
from .decode import beam_search, dynamic_decode, greedy_search  # noqa: F401
from .static_models import bert_base_pretrain_program, bert_encoder  # noqa: F401
