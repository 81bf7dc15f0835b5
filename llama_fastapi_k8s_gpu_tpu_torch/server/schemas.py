"""Request schemas — field-for-field the reference's ``data/requests.py``,
plus the OpenAI ``/v1/chat/completions`` request the JAX package's server
accepts (llama_fastapi_k8s_gpu_tpu/server/schemas.py).

Plain dataclasses with explicit validation (the GPU image carries no
pydantic), coercing as pydantic v2's lax mode does for JSON input.  :meth:`Model.validate` raises :class:`ValidationError` whose
``errors()`` are the ones pydantic v2 reports for the same input (type,
loc, msg, input, ctx), so a malformed body gets the same 422 body as from
the JAX package's server.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, ClassVar


class ValidationError(ValueError):
    def __init__(self, errors: list[dict]):
        super().__init__(f"{len(errors)} validation error(s)")
        self._errors = errors

    def errors(self) -> list[dict]:
        return self._errors


class Opt:
    """A field type that also takes ``None``."""

    def __init__(self, typ):
        self.typ = typ


class OneOf:
    """A union, tried member by member; each member is (tag, type), the tag
    being the name pydantic puts into an error's ``loc``."""

    def __init__(self, *members):
        self.members = members


class Model:
    """Base of the request dataclasses.  ``FIELDS`` declares each field as
    (name, type, required) in order, where type is ``str``, ``bool``,
    ``int``, ``float``, ``"str?"`` (str or None), :class:`Opt`,
    :class:`OneOf`, a Model subclass, or ``[type]`` (a list of it)."""

    FIELDS: ClassVar[tuple] = ()

    @classmethod
    def validate(cls, data: Any):
        errors: list[dict] = []
        out = cls._check(data, [], errors)
        if errors:
            raise ValidationError(errors)
        return out

    @classmethod
    def _check(cls, data, loc, errors):
        if not isinstance(data, dict):
            errors.append({
                "type": "model_type", "loc": loc,
                "msg": f"Input should be a valid dictionary or instance of {cls.__name__}",
                "input": data, "ctx": {"class_name": cls.__name__}})
            return None
        kw = {}
        for name, typ, required in cls.FIELDS:
            if name not in data:
                if required:
                    errors.append({"type": "missing", "loc": loc + [name],
                                   "msg": "Field required", "input": data})
                continue
            kw[name] = _check_value(typ, data[name], loc + [name], errors)
        return cls(**kw)


#: the strings pydantic reads as booleans (case-insensitive, not stripped)
_TRUE = ("1", "on", "t", "true", "y", "yes")
_FALSE = ("0", "off", "f", "false", "n", "no")
#: an integer string: digits with ``_`` separators, an optional ``.0*``
_INT_STR = re.compile(r"[+-]?\d+(?:_\d+)*(?:\.0*)?")


def _err(errors, typ, loc, msg, value):
    errors.append({"type": typ, "loc": loc, "msg": msg, "input": value})


def _check_int(value, loc, errors):
    if isinstance(value, (bool, int)):
        return int(value)
    if isinstance(value, float):
        if math.isfinite(value) and not value.is_integer():
            _err(errors, "int_from_float", loc, "Input should be a valid integer, "
                 "got a number with a fractional part", value)
        elif not math.isfinite(value) or abs(value) >= 2 ** 63:
            _err(errors, "int_parsing_size", loc, "Unable to parse input string "
                 "as an integer, exceeded maximum size", value)
        else:
            return int(value)
        return None
    if isinstance(value, str):
        s = value.strip()
        if _INT_STR.fullmatch(s):
            return int(s.split(".")[0])
        _err(errors, "int_parsing", loc, "Input should be a valid integer, "
             "unable to parse string as an integer", value)
        return None
    _err(errors, "int_type", loc, "Input should be a valid integer", value)
    return None


def _check_float(value, loc, errors):
    if isinstance(value, (bool, int, float)):
        return float(value)
    if isinstance(value, str):
        try:
            return float(value.strip())
        except ValueError:
            _err(errors, "float_parsing", loc, "Input should be a valid number, "
                 "unable to parse string as a number", value)
            return None
    _err(errors, "float_type", loc, "Input should be a valid number", value)
    return None


def _check_bool(value, loc, errors):
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.lower() in _TRUE + _FALSE:
        return value.lower() in _TRUE
    if isinstance(value, (int, str)) or (
            isinstance(value, float) and value.is_integer() and abs(value) < 2 ** 63):
        _err(errors, "bool_parsing", loc,
             "Input should be a valid boolean, unable to interpret input", value)
    else:
        _err(errors, "bool_type", loc, "Input should be a valid boolean", value)
    return None


_SCALARS = {bool: _check_bool, int: _check_int, float: _check_float}


def _check_value(typ, value, loc, errors):
    if isinstance(typ, Opt):
        return None if value is None else _check_value(typ.typ, value, loc, errors)
    if isinstance(typ, OneOf):
        tried = []
        for tag, member in typ.members:
            errs: list[dict] = []
            out = _check_value(member, value, loc + [tag], errs)
            if not errs:
                return out
            tried += errs
        errors.extend(tried)
        return None
    if isinstance(typ, type) and typ in _SCALARS:
        return _SCALARS[typ](value, loc, errors)
    if typ in (str, "str?"):
        if isinstance(value, str) or (typ == "str?" and value is None):
            return value
        errors.append({"type": "string_type", "loc": loc,
                       "msg": "Input should be a valid string", "input": value})
        return None
    if isinstance(typ, list):
        if not isinstance(value, list):
            errors.append({"type": "list_type", "loc": loc,
                           "msg": "Input should be a valid list", "input": value})
            return None
        return [_check_value(typ[0], v, loc + [i], errors) for i, v in enumerate(value)]
    return typ._check(value, loc, errors)


@dataclasses.dataclass
class ChatMessage(Model):
    turn: str = ""
    message: str = ""
    FIELDS: ClassVar[tuple] = (("turn", str, True), ("message", str, True))


@dataclasses.dataclass
class BotProfile(Model):
    name: str = ""
    appearance: str = ""
    system_prompt: str | None = ""
    FIELDS: ClassVar[tuple] = (("name", str, True), ("appearance", str, True),
                               ("system_prompt", "str?", False))


@dataclasses.dataclass
class UserProfile(Model):
    name: str = ""
    FIELDS: ClassVar[tuple] = (("name", str, True),)


@dataclasses.dataclass
class BotMessageRequest(Model):
    bot_profile: BotProfile | None = None
    user_profile: UserProfile | None = None
    context: list[ChatMessage] = dataclasses.field(default_factory=list)
    # which model serves the request (multi-model pods); a single-model pod
    # serves only its own name
    model: str | None = None
    FIELDS: ClassVar[tuple] = (("bot_profile", BotProfile, True),
                               ("user_profile", UserProfile, True),
                               ("context", [ChatMessage], True),
                               ("model", "str?", False))


# ---------------------------------------------------------------------------
# the OpenAI facade (POST /v1/chat/completions)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpenAIChatMessage(Model):
    role: str = ""
    content: str = ""
    FIELDS: ClassVar[tuple] = (("role", str, True), ("content", str, True))


@dataclasses.dataclass
class StreamOptions(Model):
    include_usage: bool = False
    FIELDS: ClassVar[tuple] = (("include_usage", bool, False),)


@dataclasses.dataclass
class ChatCompletionRequest(Model):
    """The OpenAI chat-completions request subset the server honors.
    Sampling fields left unset take the pod's serving defaults."""

    messages: list[OpenAIChatMessage] = dataclasses.field(default_factory=list)
    model: str | None = None
    stream: bool = False
    stream_options: StreamOptions | None = None
    max_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    stop: str | list[str] | None = None
    seed: int | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    n: int = 1
    user: str | None = None
    FIELDS: ClassVar[tuple] = (
        ("messages", [OpenAIChatMessage], True),
        ("model", "str?", False),
        ("stream", bool, False),
        ("stream_options", Opt(StreamOptions), False),
        ("max_tokens", Opt(int), False),
        ("temperature", Opt(float), False),
        ("top_p", Opt(float), False),
        ("stop", Opt(OneOf(("str", str), ("list[str]", [str]))), False),
        ("seed", Opt(int), False),
        ("frequency_penalty", Opt(float), False),
        ("presence_penalty", Opt(float), False),
        ("n", int, False),
        ("user", "str?", False),
    )
