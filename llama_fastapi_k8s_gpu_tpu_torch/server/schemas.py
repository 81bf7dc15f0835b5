"""Request schemas — field-for-field the reference's ``data/requests.py``.

Plain dataclasses with explicit validation (the GPU image carries no
pydantic).  :meth:`Model.validate` raises :class:`ValidationError` whose
``errors()`` are the ones pydantic v2 reports for the same input (type,
loc, msg, input, ctx), so a malformed body gets the same 422 body as from
the JAX package's server.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar


class ValidationError(ValueError):
    def __init__(self, errors: list[dict]):
        super().__init__(f"{len(errors)} validation error(s)")
        self._errors = errors

    def errors(self) -> list[dict]:
        return self._errors


class Model:
    """Base of the request dataclasses.  ``FIELDS`` declares each field as
    (name, type, required) in order, where type is ``str``, ``"str?"``
    (str or None), a Model subclass, or ``[Model]`` (a list of it)."""

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


def _check_value(typ, value, loc, errors):
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
        return [typ[0]._check(v, loc + [i], errors) for i, v in enumerate(value)]
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
