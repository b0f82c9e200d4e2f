"""Scripted-oracle VLM backend: the evaluation/distillation harness for the
slow reasoning path.

No public VLM checkpoint is reachable in this image (no network egress), so
the serving-path contract is proven with a ground-truth-backed oracle: it
answers the three slow-path calls (reference
fsr_vln/memory/hmsg/graph/graph.py:2440-2482 detect_object_in_image,
:2292-2348 vlm_choose, :2350-2438 detect_and_select_best_gpt) from the
synthetic scene's known frame contents instead of a generative model.  With
it, tests/test_query.py::test_slow_path_oracle_improves_retrieval measures
fast-vs-slow retrieval accuracy and shows the slow path *correcting* fast-path
errors — the reference's FSR claim — end-to-end through the real engine code.

The oracle doubles as a distillation teacher: `distill_pairs` emits
(prompt, images, answer) tuples in the batcher's request schema, so a real
checkpoint (loaded via models.vlm.convert_hf_llava) can be fine-tuned or
smoke-tested against the same ground truth.

Frames are identified by a tag pixel (`tag_image`/`read_tag`) because the
engine hands backends raw image arrays, exactly like the reference hands
GPT-4V rendered frames.

The port's own copy of holoagent_tpu/query/oracle.py (numpy only).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np


def tag_image(image: np.ndarray, img_id: int) -> np.ndarray:
    """Stamp a frame id into the corner pixel (value = id / 1000)."""
    out = np.array(image, np.float32, copy=True)
    out[0, 0, 0] = img_id / 1000.0
    return out


def read_tag(image: np.ndarray) -> int:
    return int(round(float(np.asarray(image)[0, 0, 0]) * 1000.0))


class OracleVLM:
    """VLMBackend answering from ground-truth frame contents.

    frame_contents: img_id -> set of object names visible in that frame.
    """

    def __init__(self, frame_contents: Dict[int, Set[str]]):
        self.frame_contents = {
            int(k): {s.lower() for s in v} for k, v in frame_contents.items()
        }
        self.calls: List[Tuple[str, object]] = []  # call log for harness asserts

    # -- helpers ------------------------------------------------------------

    def _contents(self, image) -> Set[str]:
        return self.frame_contents.get(read_tag(image), set())

    @staticmethod
    def _mentions(label: str, contents: Set[str]) -> bool:
        lab = label.lower().strip()
        return any(lab in name or name in lab for name in contents)

    # -- VLMBackend protocol ------------------------------------------------

    def detect_object(self, image, label) -> bool:
        self.calls.append(("detect_object", label))
        return self._mentions(label, self._contents(image))

    def choose_frame(self, images: Sequence[np.ndarray], instruction: str) -> Optional[int]:
        self.calls.append(("choose_frame", instruction))
        if not len(images):
            return None
        words = instruction.lower()
        for i, im in enumerate(images):
            if any(name in words for name in self._contents(im)):
                return i
        return 0

    def detect_and_select_best(self, images, label):
        self.calls.append(("detect_and_select_best", label))
        checks = [self._mentions(label, self._contents(im)) for im in images]
        best = checks.index(True) if any(checks) else None
        return checks, best

    # -- distillation harness ----------------------------------------------

    def distill_pairs(
        self, img_ids: Iterable[int], labels: Iterable[str]
    ) -> List[Tuple[str, List[int], str]]:
        """(prompt, [img_id], target answer) tuples in the batcher's prompt
        schema — supervision for fine-tuning a loaded checkpoint against the
        same ground truth the oracle answers from."""
        out = []
        for i in img_ids:
            contents = self.frame_contents.get(int(i), set())
            for lab in labels:
                ans = "yes" if self._mentions(lab, contents) else "no"
                out.append(
                    (f"is there a {lab} in this image? answer yes or no.", [int(i)], ans)
                )
        return out
