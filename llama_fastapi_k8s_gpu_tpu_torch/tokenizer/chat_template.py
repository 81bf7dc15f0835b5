"""Chat template rendering.

The reference passes OpenAI-style ``[{'role', 'content'}]`` message lists to
``create_chat_completion`` (reference api.py:56-57, built at api.py:122-147);
llama.cpp renders them with the GGUF-embedded jinja template.  Rather than
evaluating jinja, the known template families are implemented directly and
selected by fingerprinting the template string — the same approach llama.cpp's
``llama_chat_apply_template`` takes.

Supported: ``llama3`` (<|start_header_id|>…), ``mistral`` ([INST] …),
``chatml`` (<|im_start|>…).
"""

from __future__ import annotations

from typing import Sequence

from .base import Tokenizer


def detect_chat_template(template: str | None, tokenizer: Tokenizer) -> str:
    if template:
        if "<|start_header_id|>" in template:
            return "llama3"
        if "[INST]" in template:
            return "mistral"
        if "<|im_start|>" in template:
            return "chatml"
    # fall back on vocab fingerprints
    if "<|start_header_id|>" in tokenizer.token_to_id:
        return "llama3"
    if "<|im_start|>" in tokenizer.token_to_id:
        return "chatml"
    return "mistral"


def render_llama3(messages: Sequence[dict]) -> str:
    out = []
    for m in messages:
        out.append(
            f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
            f"{m['content'].strip()}<|eot_id|>"
        )
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def render_chatml(messages: Sequence[dict]) -> str:
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m['content'].strip()}<|im_end|>\n")
    out.append("<|im_start|>assistant\n")
    return "".join(out)


def render_mistral(messages: Sequence[dict], eos_piece: str = "</s>") -> str:
    """[INST] blocks; system text is folded into the first user message
    (mistral templates have no system role)."""
    system = ""
    out = []
    pending_system = ""
    for m in messages:
        role, content = m["role"], m["content"].strip()
        if role == "system":
            pending_system = content
            continue
        if role == "user":
            if pending_system:
                content = pending_system + "\n\n" + content
                pending_system = ""
            out.append(f"[INST] {content} [/INST]")
        else:  # assistant
            out.append(f" {content}{eos_piece}")
    if pending_system and not out:
        out.append(f"[INST] {pending_system} [/INST]")
    return "".join(out)


def apply_chat_template(
    tokenizer: Tokenizer,
    messages: Sequence[dict],
    template: str | None = None,
    kind: str | None = None,
) -> list[int]:
    """Messages → prompt token ids, ending with the assistant header so the
    model's next token begins the reply."""
    kind = kind or detect_chat_template(template, tokenizer)
    if kind == "llama3":
        text = render_llama3(messages)
    elif kind == "chatml":
        text = render_chatml(messages)
    elif kind == "mistral":
        text = render_mistral(messages)
    else:
        raise ValueError(f"unknown chat template kind: {kind}")
    return tokenizer.encode(text, add_bos=True, parse_special=True)
