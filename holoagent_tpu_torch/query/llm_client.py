"""LLM client plumbing: conversations, caching, bounded retries (the port's
own copy of holoagent_tpu/query/llm_client.py).

The backend is any callable taking a chat message list: the port's
ContinuousBatcher (``batcher_backend``), an OpenAI-compatible HTTP endpoint
(``openai_http_backend``), or a test stub.  Retries are bounded with
exponential backoff, and responses persist in a JSONL cache keyed by the
first 32 hex digits of the sha256 of ``json.dumps(messages,
sort_keys=True)``, the JAX package's key: a cache file written by either
package is read by the other.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional


@dataclass
class Conversation:
    """Message list in chat format (reference llm_utils Conversation)."""

    messages: List[Dict[str, str]] = field(default_factory=list)

    def add(self, role: str, content: str) -> "Conversation":
        self.messages.append({"role": role, "content": content})
        return self

    def system(self, content: str) -> "Conversation":
        return self.add("system", content)

    def user(self, content: str) -> "Conversation":
        return self.add("user", content)

    def assistant(self, content: str) -> "Conversation":
        return self.add("assistant", content)

    def render(self) -> str:
        """Flatten to a single prompt for completion-style backends."""
        return "\n".join(f"{m['role']}: {m['content']}" for m in self.messages) + "\nassistant:"


class CachedLLMClient:
    """send_query with persistent caching + bounded exponential backoff."""

    def __init__(
        self,
        backend: Callable[[List[Dict[str, str]]], str],
        cache_path: Optional[str | Path] = None,
        max_retries: int = 3,
        backoff_s: float = 0.5,
    ):
        self.backend = backend
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.cache_path = Path(cache_path) if cache_path else None
        self._cache: Dict[str, str] = {}
        if self.cache_path and self.cache_path.exists():
            for line in self.cache_path.read_text().splitlines():
                if line.strip():
                    rec = json.loads(line)
                    self._cache[rec["key"]] = rec["response"]

    @staticmethod
    def _key(messages: List[Dict[str, str]]) -> str:
        return hashlib.sha256(
            json.dumps(messages, sort_keys=True).encode()
        ).hexdigest()[:32]

    def send_query(self, conversation: Conversation | List[Dict[str, str]]) -> str:
        messages = (
            conversation.messages
            if isinstance(conversation, Conversation)
            else conversation
        )
        key = self._key(messages)
        if key in self._cache:
            return self._cache[key]
        err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                resp = self.backend(messages)
                self._cache[key] = resp
                if self.cache_path:
                    with open(self.cache_path, "a") as f:
                        f.write(json.dumps({"key": key, "response": resp}) + "\n")
                return resp
            except Exception as e:  # noqa: BLE001 - backend errors are opaque
                err = e
                time.sleep(self.backoff_s * (2**attempt))
        raise RuntimeError(
            f"LLM backend failed after {self.max_retries} retries"
        ) from err


def batcher_backend(batcher, max_new_tokens: int = 64):
    """Adapt the port's ``serving.batcher.ContinuousBatcher`` to the
    chat-backend signature: the rendered conversation through
    ``batcher.generate``."""

    def call(messages: List[Dict[str, str]]) -> str:
        prompt = Conversation(list(messages)).render()
        return batcher.generate(prompt, max_new_tokens=max_new_tokens)

    return call


def openai_http_backend(
    endpoint: str, api_key: str, model: str, temperature: float = 0.0,
    timeout_s: float = 30.0,
):
    """OpenAI-compatible chat-completions backend, for deployments with an
    external service (nothing in the repository calls it)."""
    import urllib.request

    def call(messages: List[Dict[str, str]]) -> str:
        body = json.dumps(
            {"model": model, "messages": messages, "temperature": temperature}
        ).encode()
        req = urllib.request.Request(
            endpoint.rstrip("/") + "/chat/completions",
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {api_key}",
            },
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            out = json.loads(r.read())
        return out["choices"][0]["message"]["content"]

    return call
