"""Token constants, question and answer templates, the seg-token registry
and the task ids of the PyTorch port.

A copy of ``interactvlm_tpu/utils/constants.py`` (the reference's prompt
machinery, ``utils/utils.py:12-138`` and ``add_new_tokens`` :335-362), with
the task-id encoding of ``interactvlm_tpu/data/collate.py`` and the SAM
pixel statistics of ``models/sam/sam.py``. The template lists drive the
datasets' conversations; the ``[HTOKEN]`` / ``[OTOKEN]`` placeholders
become the configured seg tokens by ``token_type`` (Gen / Gen-Int /
Gen-Hu-Obj).
"""

from __future__ import annotations

from typing import Tuple

from interactvlm_tpu_torch.geometry.views import (  # noqa: F401
    DAMON_CATEGORIES_MAPPING,
)

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
# sentinel for patch positions in spliced id space (never a real token)
PATCH_ID = -1
IGNORE_LABEL = -1
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

SAM_MEAN_PIXEL = (123.675, 116.28, 103.53)
SAM_STD_PIXEL = (58.395, 57.12, 57.375)
# SAM pixel normalization (reference build_sam.py:104-105)
PIXEL_MEAN, PIXEL_STD = SAM_MEAN_PIXEL, SAM_STD_PIXEL
CLIP_MEAN_PIXEL = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD_PIXEL = (0.26862954, 0.26130258, 0.27577711)

_I = DEFAULT_IMAGE_TOKEN + "\n"

SHORT_QUESTION_LIST = [
    _I + "Can you segment the {class_name} in this image?",
    _I + "Please segment the {class_name} in this image.",
    _I + "What is {class_name} in this image? Please respond with segmentation mask.",
    _I + "What is {class_name} in this image? Please output segmentation mask.",
]

HCONTACT_QUESTION_LIST = [
    _I + "Segment the area on the human's body that is in direct contact with the {class_name} in this image.",
    _I + "Identify and mask the part of the human that is touching or interacting with the {class_name} in this scene.",
    _I + "Show the contact points on the human where they are physically connected to or interacting with {class_name}.",
    _I + "Please provide a segmentation mask of the human's body parts that are in contact with {class_name}.",
    _I + "Highlight the areas on the human where there is physical interaction or contact with {class_name}.",
]

HCONTACT_PARTS_QUESTION_LIST = [
    _I + "Which body parts are in contact with the {class_name}? Segment these contact areas.",
    _I + "Name and segment the specific body parts making contact with the {class_name}.",
    _I + "Looking at the {class_name}, what parts of the human body are touching it? Show these contact regions.",
    _I + "For the {class_name}, list and mask the human body parts that are in contact.",
    _I + "Regarding the {class_name}, identify which body parts are touching it and highlight these contact areas.",
]

OAFFORD_QUESTION_LIST = [
    _I + "Segment the area on the {class_name} where the human is making direct contact in this image.",
    _I + "Identify and mask the part of the {class_name} that the human is touching or interacting with in this scene.",
    _I + "Show the contact points on the {class_name} where the human is physically connected to or interacting with it.",
    _I + "Please provide a segmentation mask of the parts of the {class_name} that are in contact with the human.",
    _I + "Highlight the areas on the {class_name} where there is physical interaction or contact with the human.",
]

OCONTACT_QUESTION_LIST = list(OAFFORD_QUESTION_LIST)

OAFFORD_AFFORD_QUESTION_LIST = [
    _I + "What type of affordance does the human-object interaction suggest? Then, segment the area on the {class_name} where the human is making contact.",
    _I + "Describe the affordance provided by the interaction, and identify the part of the {class_name} that the human is touching or interacting with in this scene.",
    _I + "Explain the affordance type shown by the contact points on the {class_name} where the human is physically connected. Then show the segmentation mask.",
    _I + "Specify the affordance implied by the human's contact with the {class_name}, then provide a segmentation mask of the contact area.",
    _I + "Describe the affordance associated with the physical interaction on the {class_name}, and highlight the contact areas with a segmentation mask.",
]

LONG_QUESTION_LIST = [
    _I + "{sent} Please respond with segmentation mask.",
    _I + "{sent} Please output segmentation mask.",
]

EXPLANATORY_QUESTION_LIST = [
    "Please output segmentation mask and explain why.",
    "Please output segmentation mask and explain the reason.",
    "Please output segmentation mask and give some explanation.",
]

ANSWER_LIST = [
    "It is [SEG].",
    "Sure, [SEG].",
    "Sure, it is [SEG].",
    "Sure, the segmentation result is [SEG].",
    "[SEG].",
]

HCONTACT_ANSWER_LIST = [
    "It is [HTOKEN].",
    "Sure, the human contact region is [HTOKEN].",
    "Sure, the contact points on human is [HTOKEN].",
    "Sure, the contact mask is [HTOKEN].",
    "[HTOKEN].",
]

HCONTACT_PARTS_ANSWER_LIST = [
    "The contacting body parts are {body_parts}, and the contact region is [HTOKEN].",
    "The involved body parts are {body_parts}, with the contact mask at [HTOKEN].",
    "Contact occurs at {body_parts}, with the contact points shown at [HTOKEN].",
    "The body parts in contact are {body_parts}, with contact mask at [HTOKEN].",
    "Body parts: {body_parts}, contact mask: [HTOKEN].",
]

OAFFORD_ANSWER_LIST = [
    "It is [OTOKEN].",
    "Sure, the object contact region is [OTOKEN].",
    "Sure, the contact points on object is [OTOKEN].",
    "Sure, the contact mask is [OTOKEN].",
    "[OTOKEN].",
]

OCONTACT_ANSWER_LIST = list(OAFFORD_ANSWER_LIST)

OAFFORD_AFFORD_ANSWER_LIST = [
    "The affordance type is {affordance}, and the contact region is [OTOKEN].",
    "This interaction suggests an affordance of {affordance}, and the object contact region is [OTOKEN].",
    "The contact points indicate an affordance of {affordance}, with the mask at [OTOKEN].",
    "This shows an affordance type of {affordance}, with contact at [OTOKEN].",
    "Affordance: {affordance}, contact mask: [OTOKEN].",
]

OAFFORD_AFFORD_OBJ_ANSWER_LIST = [
    "The affordance type is {affordance} with {class_name}, and the contact region is [OTOKEN].",
    "This interaction suggests an affordance of {affordance} with {class_name}, and the object contact region is [OTOKEN].",
    "The contact points indicate an affordance of {affordance} with {class_name}, with the mask at [OTOKEN].",
    "This shows an affordance type of {affordance} with {class_name}, with contact at [OTOKEN].",
    "Affordance: {affordance} with {class_name}, contact mask: [OTOKEN].",
]


def seg_token_strings(token_type: str) -> Tuple[str, str, str]:
    """(general, human-placeholder, object-placeholder) token strings for a
    ``token_type`` (reference add_new_tokens, utils/utils.py:335-362)."""
    base = token_type.replace("-DifDe", "")
    if base == "Gen":
        return "[SEG]", "[SEG]", "[SEG]"
    if base == "Gen-Int":
        return "[SEG]", "[ISEG]", "[ISEG]"
    if base == "Gen-Hu-Obj":
        return "[SEG]", "[HSEG]", "[OSEG]"
    raise ValueError(f"unknown token_type {token_type}")


def add_new_tokens(tokenizer, token_type: str):
    """Extend an HF tokenizer with the seg tokens; returns
    (tokenizer, seg_idx, hseg_idx, oseg_idx)."""

    def add(token):
        tokenizer.add_tokens(token)
        return tokenizer(token, add_special_tokens=False)["input_ids"][0]

    gen, hu, ob = seg_token_strings(token_type)
    seg_idx = add(gen)
    hseg_idx = add(hu) if hu != gen else seg_idx
    oseg_idx = add(ob) if ob not in (gen, hu) else (
        seg_idx if ob == gen else hseg_idx
    )
    return tokenizer, seg_idx, hseg_idx, oseg_idx


def substitute_seg_tokens(text: str, token_type: str) -> str:
    """Replace the [HTOKEN]/[OTOKEN] placeholders in answer templates with
    the configured seg tokens."""
    gen, hu, ob = seg_token_strings(token_type)
    return text.replace("[HTOKEN]", hu).replace("[OTOKEN]", ob)


# dataset name -> task id of a batch row (the JAX package's encoding,
# ``interactvlm_tpu/data/collate.py``; ``models/interactvlm.py`` reads it)
TASK_IDS = {
    "vqa": 0,
    "sem_seg": 1,
    "refer_seg": 1,
    "reason_seg": 1,
    "h2dcontact": 1,
    "hcontact": 2,
    "hcontact_scene": 2,
    "oafford": 3,
    "ocontact": 4,
}
