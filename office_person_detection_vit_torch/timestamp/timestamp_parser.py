"""Timestamp string parsing with fuzzy OCR-error repair
(reference src/timestamp/timestamp_parser.py:21-169).

The port's own copy of ``office_person_detection_vit_tpu/timestamp/timestamp_parser.py`` (host code, unchanged).
"""

from __future__ import annotations

import re
from datetime import datetime

PATTERNS = [
    # 2025/01/20 12:34:56 or 12:34
    (re.compile(r"(\d{4})/(\d{1,2})/(\d{1,2})\s+(\d{1,2}):(\d{1,2})(?::(\d{1,2}))?"), "ymd"),
    # 2025-01-20 12:34[:56]
    (re.compile(r"(\d{4})-(\d{1,2})-(\d{1,2})\s+(\d{1,2}):(\d{1,2})(?::(\d{1,2}))?"), "ymd"),
    # Japanese date: 2025年1月20日 12時34分[56秒]
    (re.compile(r"(\d{4})年(\d{1,2})月(\d{1,2})日\s*(\d{1,2})時(\d{1,2})分(?:(\d{1,2})秒)?"), "ymd"),
]

#: OCR character-confusion fixes (reference :76-86).
CHAR_FIXES = str.maketrans(
    {"O": "0", "o": "0", "l": "1", "I": "1", "S": "5", "s": "5", "B": "8", "Z": "2", "G": "6", "D": "0", "Q": "0"}
)

#: Structural repairs for missing separators (reference :92-156).
REPAIRS = [
    # 20250120 123456 -> 2025/01/20 12:34:56
    (re.compile(r"^(\d{4})(\d{2})(\d{2})\s+(\d{2})(\d{2})(\d{2})$"), r"\1/\2/\3 \4:\5:\6"),
    # 2025/01/20123456 (lost space and colons) -> 2025/01/20 12:34:56
    (re.compile(r"^(\d{4}/\d{2}/\d{2})\s*(\d{2}):?(\d{2}):?(\d{2})$"), r"\1 \2:\3:\4"),
    # 2025/01/201234 (lost space, colon glyph dropped — blurred/small dots
    # fall under Otsu) -> 2025/01/20 12:34
    (re.compile(r"^(\d{4}/\d{2}/\d{2})\s*(\d{2})(\d{2})$"), r"\1 \2:\3"),
    # 2025/0120 -> 2025/01/20
    (re.compile(r"(\d{4})/(\d{2})(\d{2})\s"), r"\1/\2/\3 "),
    # missing space: 2025/01/2012:34 -> 2025/01/20 12:34
    (re.compile(r"(\d{4}/\d{2}/\d{2})(\d{2}:)"), r"\1 \2"),
    # 12 34 56 time with spaces -> 12:34:56
    (re.compile(r"\s(\d{2})\s(\d{2})\s(\d{2})$"), r" \1:\2:\3"),
    # double slash / stray chars
    (re.compile(r"//+"), "/"),
    (re.compile(r"::+"), ":"),
]


class TimestampParser:
    def parse(self, text: str) -> datetime | None:
        text = text.strip()
        for pattern, _ in PATTERNS:
            m = pattern.search(text)
            if not m:
                continue
            y, mo, d, h, mi = (int(m.group(i)) for i in range(1, 6))
            s = int(m.group(6)) if m.group(6) else 0
            try:
                return datetime(y, mo, d, h, mi, s)
            except ValueError:
                continue
        return None

    def fuzzy_parse(self, text: str) -> datetime | None:
        """parse() with char-confusion fixes and structural repairs
        (reference :59-156)."""
        direct = self.parse(text)
        if direct is not None:
            return direct
        fixed = text.translate(CHAR_FIXES)
        fixed = re.sub(r"[^\d/: ]", "", fixed)
        fixed = re.sub(r"\s+", " ", fixed).strip()
        result = self.parse(fixed)
        if result is not None:
            return result
        for pattern, repl in REPAIRS:
            candidate = pattern.sub(repl, fixed)
            if candidate != fixed:
                result = self.parse(candidate)
                if result is not None:
                    return result
                fixed = candidate
        return self.parse(fixed)
