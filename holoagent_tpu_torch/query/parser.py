"""Hierarchical query parsing: "object X in room Y on floor Z" -> (floor,
room, object).

The port's own copy of holoagent_tpu/query/parser.py, ``RuleParser`` only
(Chinese shapes included).  ``LLMParser`` waits for the port of
``query/llm_client.py`` (ROADMAP.md).

The reference parses with an Azure GPT call
(reference fsr_vln/memory/hmsg/utils/llm_utils.py:383-466
`parse_hier_query_use_prompt_insentence_parse_icra`); the deterministic rule
parser here is the hermetic default."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass
class ParsedQuery:
    floor: Optional[str]
    room: Optional[str]
    object: Optional[str]

    def astuple(self) -> Tuple[Optional[str], Optional[str], Optional[str]]:
        return (self.floor, self.room, self.object)


_FLOOR_PAT = re.compile(
    r"\s*(?:on|at)\s+(?:the\s+)?((?:floor|level|story)\s*\w+|\w+\s+(?:floor|level))\s*$",
    re.IGNORECASE,
)
_ROOM_PAT = re.compile(
    r"\s*(?:in|inside|at)\s+(?:the\s+)?(?:region\s+)?([\w\s]+?)\s*$", re.IGNORECASE
)
_ORDINALS = {
    "first": "1", "second": "2", "third": "3", "fourth": "4", "fifth": "5",
    "ground": "1", "1st": "1", "2nd": "2", "3rd": "3", "4th": "4", "5th": "5",
}


class RuleParser:
    """Deterministic parser for the benchmark query shapes
    ("mirror in region bathroom on floor 0", "find the sofa in the living
    room", bare object queries)."""

    def __init__(self, spec: Sequence[str] = ("obj", "room", "floor")):
        self.spec = set(spec)

    def __call__(self, instruction: str) -> ParsedQuery:
        text = instruction.strip().rstrip(".?!。？！")
        if _ZH_HINT.search(text):
            return self._parse_zh(text)
        # strip leading imperatives
        text = re.sub(
            r"^(?:please\s+)?(?:find|go to|bring me|navigate to|take me to|locate|look for)\s+(?:the\s+|a\s+|an\s+)?",
            "",
            text,
            flags=re.IGNORECASE,
        )
        floor = room = None
        if "floor" in self.spec:
            m = _FLOOR_PAT.search(text)
            if m:
                floor = m.group(1).strip()
                text = text[: m.start()].strip()
                # normalize "second floor" -> "floor 2" digits for query_floor
                words = floor.lower().split()
                digits = [w for w in words if w.isdigit() or w in _ORDINALS]
                if digits:
                    d = digits[0]
                    floor = _ORDINALS.get(d, d)
        if "room" in self.spec:
            m = _ROOM_PAT.search(text)
            if m and m.group(1).strip():
                room = m.group(1).strip()
                text = text[: m.start()].strip()
        obj = text.strip() or None
        if "room" not in self.spec:
            room = None
        if "floor" not in self.spec:
            floor = None
        return ParsedQuery(floor=floor, room=room, object=obj)

    def _parse_zh(self, text: str) -> ParsedQuery:
        """Chinese query shapes (the zh prompt variant of reference
        llm_utils.py:310-466): 「去N楼的R找O」 / 「在R里找O」 / 「带我去O」."""
        floor = room = None
        # leading politeness + imperatives (politeness strips even without a
        # following verb: 「请在卧室里找台灯」)
        text = re.sub(r"^(?:请)?(?:帮我)?(?:去|寻找|带我去|导航到|到|找)?", "", text, count=1)
        m = re.search(r"([一二三四五六七八九十\d]+)\s*(?:楼|层)(?:的)?", text)
        if m and "floor" in self.spec:
            floor = _zh_numeral(m.group(1))
            text = text.replace(m.group(0), "", 1)
        text = re.sub(r"^的", "", text)
        # "R里找O" / "R找O": the room chunk precedes 找
        m = re.match(r"(?:在)?([\w一-鿿]+?)(?:里|内|中)?(?:的)?找(.+)$", text)
        if m and "room" in self.spec and m.group(1):
            room = m.group(1)
            text = m.group(2)
        else:
            m = re.search(r"(?:在)?([\w一-鿿]+?)(?:里|内|中)(?:的)?", text)
            if m and "room" in self.spec and m.group(1):
                room = m.group(1)
                text = text.replace(m.group(0), "", 1)
        obj = re.sub(r"^(?:找|的|去)", "", text).strip(" ，,。") or None
        if "room" not in self.spec:
            room = None
        if "floor" not in self.spec:
            floor = None
        # canonicalize zh nouns to the English label vocabulary the CLIP
        # label features are built from (the role GPT translation plays in
        # the reference's zh parse, llm_utils.py:310-466); unknown nouns pass
        # through for open-vocabulary retrieval
        room = _ZH_LEXICON.get(room, room)
        obj = _ZH_LEXICON.get(obj, obj)
        return ParsedQuery(floor=floor, room=room, object=obj)


_ZH_HINT = re.compile(r"[一-鿿]")

# zh noun -> English canonical label (fixture + common indoor vocabulary)
_ZH_LEXICON = {
    "床": "bed", "椅子": "chair", "桌子": "table", "沙发": "sofa",
    "冰箱": "refrigerator", "马桶": "toilet", "浴缸": "bathtub",
    "电视": "tv", "台灯": "lamp", "灯": "lamp", "植物": "plant",
    "镜子": "mirror", "门": "door", "窗户": "window", "水槽": "sink",
    "书架": "bookshelf", "柜子": "cabinet", "枕头": "pillow",
    "卧室": "bedroom", "客厅": "living room", "浴室": "bathroom",
    "厨房": "kitchen", "餐厅": "dining room", "走廊": "hallway",
    "卫生间": "bathroom", "洗手间": "bathroom", "书房": "office",
}
_ZH_DIGITS = {
    "一": 1, "二": 2, "三": 3, "四": 4, "五": 5,
    "六": 6, "七": 7, "八": 8, "九": 9,
}


def _zh_numeral(s: str) -> str:
    """Chinese numeral (incl. compounds 十二 / 二十 / 二十三) -> digit string;
    plain digits pass through."""
    if s.isdigit():
        return s
    if "十" in s:
        tens_s, _, ones_s = s.partition("十")
        tens = _ZH_DIGITS.get(tens_s, 1) if tens_s else 1
        ones = _ZH_DIGITS.get(ones_s, 0) if ones_s else 0
        return str(tens * 10 + ones)
    if s in _ZH_DIGITS:
        return str(_ZH_DIGITS[s])
    return s
