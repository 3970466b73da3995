"""Conversation prompt templating (a copy of
``interactvlm_tpu/data/conversations.py``).

Rebuild of the reference's vendored LLaVA templating
(``model/llava/conversation.py``): the ``Conversation`` container with the
separator styles the InteractVLM pipeline uses (``llava_v1`` = vicuna-style
TWO separators; ``llava_llama_2`` = [INST] wrapping). Only the styles
reachable from the released configs are implemented.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.TWO
    sep: str = " "
    sep2: str = "</s>"
    version: str = "v1"

    def append_message(self, role: str, message):
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        messages = self.messages
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else ""

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message and role == self.roles[0]
                    message = wrap_sys(self.system) + message
                if i % 2 == 0:
                    ret += self.sep + wrap_inst(message) if message else ""
                else:
                    ret += " " + message + " " + self.sep2 if message else ""
            return ret.lstrip(self.sep)
        raise ValueError(self.sep_style)

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[list(m) for m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )


conv_llava_v1 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llava_llama_2 = Conversation(
    system=(
        "You are a helpful language and vision assistant. You are able to "
        "understand the visual content that the user provides, and assist "
        "the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_templates = {
    "llava_v1": conv_llava_v1,
    "llava_llama_2": conv_llava_llama_2,
}


def get_conversation_template(conv_type: str) -> Conversation:
    return conv_templates[conv_type].copy()
