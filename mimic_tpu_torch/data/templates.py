"""Prompt-template renderers.

The reference renders conversations through per-model Jinja chat templates
(``testbed/models/idefics.py:34-79``, ``idefics2.py:36-81``, ``llava.py:48-133``).
Prompt strings feed the tokenizer, so their whitespace must match byte-for-byte for
eval parity.  Here each template family is a small pure-Python renderer — faster than
Jinja, trivially testable, and with the quirks documented inline.

Message format (same as the retrievers produce):
``{"role": str, "content": [{"type": "text", "text": ...} | {"type": "image"}]}``;
an instruction message carries a plain-string content; a trailing answer-role message
may omit ``content`` entirely (it acts as the generation prompt).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

Message = Dict[str, Any]


def _is_end_of_round(messages: List[Message], i: int, first_role: str) -> bool:
    return i == len(messages) - 1 or messages[i + 1]["role"] == first_role


def _pop_instruction(messages: List[Message]) -> (Optional[Message], List[Message]):
    if messages and str(messages[0]["role"]).lower() in ("instruction", "system"):
        return messages[0], messages[1:]
    return None, messages


def render_idefics1(messages: List[Message], add_generation_prompt: bool = False) -> str:
    """IDEFICS-1 role-based template (reference testbed/models/idefics.py:34-79).

    Round shape: ``Image:<image> Question: q Answer: a\\n``; rounds are delimited by a
    newline after the message that closes each round (the one whose successor restarts
    with the first role).  A content-less final message renders as ``Role:`` and acts
    as the generation prompt.
    """
    out: List[str] = []
    instruction, msgs = _pop_instruction(list(messages))
    if instruction is not None:
        out.append(instruction["role"].capitalize() + ": " + instruction["content"] + "\n")
    first_role = msgs[0]["role"]
    generation_role = "Assistant"
    for i, m in enumerate(msgs):
        end_of_round = _is_end_of_round(msgs, i, first_role)
        if m["role"] != "":
            out.append(str(m["role"]).capitalize())
            if end_of_round:
                generation_role = m["role"]
            if "content" not in m or m["content"][0]["type"] == "image":
                out.append(":")
            else:
                out.append(": ")
        if "content" in m:
            lines = m["content"]
            for j, line in enumerate(lines):
                if line["type"] == "text":
                    out.append(line["text"])
                elif line["type"] == "image":
                    out.append("<image>")
                if j != len(lines) - 1:
                    out.append(" ")
            out.append("\n" if end_of_round else " ")
    if add_generation_prompt:
        out.append(str(generation_role).capitalize() + ":")
    return "".join(out)


def render_idefics2(
    messages: List[Message],
    add_generation_prompt: bool = False,
    end_token: str = "<end_of_outterance>",
) -> str:
    """IDEFICS-2 template (reference testbed/models/idefics2.py:36-81).

    Differences from IDEFICS-1: every content block is terminated by
    ``<end_of_outterance>\\n`` and content lines are concatenated with *no* separator.

    Parity note: the reference template literally emits the misspelled token
    ``<end_of_outterance>`` — and its base-model cleanup replaces the *correctly*
    spelled ``<end_of_utterance>``, so the misspelled string always survives into the
    prompt as plain text.  We reproduce that exact behavior by default; pass
    ``end_token`` to use the real token or none.
    """
    out: List[str] = []
    instruction, msgs = _pop_instruction(list(messages))
    if instruction is not None:
        out.append(
            instruction["role"].capitalize() + ": " + instruction["content"] + end_token + "\n"
        )
    first_role = msgs[0]["role"]
    generation_role = "Assistant"
    for i, m in enumerate(msgs):
        end_of_round = _is_end_of_round(msgs, i, first_role)
        if m["role"] != "":
            out.append(str(m["role"]).capitalize())
            if end_of_round:
                generation_role = m["role"]
            if "content" not in m or m["content"][0]["type"] == "image":
                out.append(":")
            else:
                out.append(": ")
        if "content" in m:
            for line in m["content"]:
                if line["type"] == "text":
                    out.append(line["text"])
                elif line["type"] == "image":
                    out.append("<image>")
            out.append(end_token + "\n")
    if add_generation_prompt:
        out.append(str(generation_role).capitalize() + ":")
    return "".join(out)


def render_llava_interleave(messages: List[Message], add_generation_prompt: bool = False) -> str:
    """LLaVA-NeXT-Interleave ChatML template (reference testbed/models/llava.py:96-133).

    ``<|im_start|>role\\n`` then all images (``<image>``), then each text prefixed by
    ``\\n``, closed by ``<|im_end|>\\n``.  A content-less final message emits only the
    ``<|im_start|>role\\n`` opener, which acts as the generation prompt.
    """
    out: List[str] = []
    instruction, msgs = _pop_instruction(list(messages))
    if instruction is not None:
        out.append(
            "<|im_start|>" + instruction["role"] + "\n" + instruction["content"] + "<|im_end|>\n"
        )
    first_role = msgs[0]["role"]
    generation_role = "assistant"
    for i, m in enumerate(msgs):
        if _is_end_of_round(msgs, i, first_role):
            generation_role = m["role"]
        out.append("<|im_start|>" + str(m["role"]) + "\n")
        if "content" in m:
            for line in m["content"]:
                if line["type"] == "image":
                    out.append("<image>")
            for line in m["content"]:
                if line["type"] == "text":
                    out.append("\n" + line["text"])
            out.append("<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>" + str(generation_role) + "\n")
    return "".join(out)


def render_llava_15(messages: List[Message], add_generation_prompt: bool = False) -> str:
    """LLaVA-1.5 template (reference testbed/models/llava.py:56-95).

    ``ROLE: `` upper-cased, all images first (each ``<image>\\n``), then each text
    followed by one space; a content-less message renders ``ROLE:``.
    """
    out: List[str] = []
    instruction, msgs = _pop_instruction(list(messages))
    if instruction is not None:
        out.append(instruction["content"] + "\n")
    first_role = msgs[0]["role"]
    generation_role = "ASSISTANT"
    for i, m in enumerate(msgs):
        if _is_end_of_round(msgs, i, first_role):
            generation_role = m["role"]
        out.append(str(m["role"]).upper())
        if "content" in m:
            out.append(": ")
            for line in m["content"]:
                if line["type"] == "image":
                    out.append("<image>\n")
            for line in m["content"]:
                if line["type"] == "text":
                    out.append(line["text"] + " ")
        else:
            out.append(":")
    if add_generation_prompt:
        out.append(str(generation_role).upper() + ":")
    return "".join(out)


TEMPLATE_RENDERERS = {
    "idefics1": render_idefics1,
    "idefics2": render_idefics2,
    "llava-interleave": render_llava_interleave,
    "llava-1.5": render_llava_15,
}


def apply_prompt_template(
    conversation,
    template: str,
    add_generation_prompt: bool = False,
):
    """Render one conversation or a batch of conversations with a named template."""
    try:
        render = TEMPLATE_RENDERERS[template]
    except KeyError:
        raise ValueError(
            f"Unknown template {template!r}; valid: {', '.join(TEMPLATE_RENDERERS)}"
        ) from None
    if conversation and isinstance(conversation[0], list):
        return [render(c, add_generation_prompt) for c in conversation]
    return render(conversation, add_generation_prompt)
