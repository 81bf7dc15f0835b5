from .base import Tokenizer, TokenType  # noqa: F401
from .bpe import BPETokenizer  # noqa: F401
from .chat_template import apply_chat_template, detect_chat_template  # noqa: F401
from .loader import tokenizer_from_gguf  # noqa: F401
from .spm import SPMTokenizer  # noqa: F401
