"""Resource resolution + downloader surface — the port of
``deeplearning4j_tpu/utils/resources.py`` (pure Python, no device code, so
a copy).

Reference: nd4j-common ``org/nd4j/common/resources/{DL4JResources,
Resources}.java`` and ``Downloader.java`` (strumpf resource resolver —
SURVEY.md §2.3 "Common utils" row).

Zero-egress adaptation: ``Downloader`` resolves artifacts from a LOCAL
mirror directory instead of the network (same contract the pretrained-zoo
repository uses — place files under ``$DL4J_TPU_DATA_DIR/mirror`` or pass
``mirror=``); checksum verification, cache layout and the resolver search
path are real.
"""
from __future__ import annotations

import hashlib
import os
import shutil
from typing import List, Optional

__all__ = ["DL4JResources", "Resources", "Downloader"]


class DL4JResources:
    """Reference: DL4JResources — root data directory + subdir layout."""

    @staticmethod
    def getBaseDirectory() -> str:
        d = os.environ.get("DL4J_TPU_DATA_DIR",
                           os.path.expanduser("~/.deeplearning4j_tpu"))
        os.makedirs(d, exist_ok=True)
        return d

    @staticmethod
    def getDirectory(resourceType: str, name: str = "") -> str:
        d = os.path.join(DL4JResources.getBaseDirectory(),
                         str(resourceType), name)
        os.makedirs(d, exist_ok=True)
        return d


class Resources:
    """Reference: strumpf ``Resources.asFile`` — resolve a relative
    resource path against registered search directories."""

    _dirs: List[str] = []

    @classmethod
    def registerDirectory(cls, path: str) -> None:
        if path not in cls._dirs:
            cls._dirs.append(path)

    @classmethod
    def asFile(cls, path: str) -> str:
        if os.path.isabs(path) and os.path.exists(path):
            return path
        for root in cls._dirs + [DL4JResources.getBaseDirectory()]:
            cand = os.path.join(root, path)
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            f"Resource {path!r} not found under {cls._dirs} or "
            f"{DL4JResources.getBaseDirectory()}")

    @classmethod
    def exists(cls, path: str) -> bool:
        try:
            cls.asFile(path)
            return True
        except FileNotFoundError:
            return False


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Downloader:
    """Reference: nd4j-common ``Downloader.download(name, url, file, md5,
    maxTries)``.  Zero-egress: the url's filename is looked up in a local
    mirror directory; the checksum/caching contract is unchanged."""

    @staticmethod
    def download(name: str, url: str, targetFile: str,
                 md5: Optional[str] = None, maxTries: int = 3,
                 mirror: Optional[str] = None) -> str:
        if os.path.exists(targetFile):
            if md5 is None or _md5(targetFile) == md5:
                return targetFile
            os.remove(targetFile)        # corrupt cache entry: re-fetch
        mirror_dir = mirror or os.environ.get(
            "DL4J_TPU_MIRROR",
            os.path.join(DL4JResources.getBaseDirectory(), "mirror"))
        fname = os.path.basename(str(url).rstrip("/"))
        src = os.path.join(mirror_dir, fname)
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"Downloader({name}): no network egress in this "
                f"environment and {fname!r} is not in the local mirror "
                f"{mirror_dir}; place the file there to 'download' it.")
        if md5 is not None and _md5(src) != md5:
            raise IOError(f"Downloader({name}): checksum mismatch for "
                          f"{src} (expected {md5})")
        os.makedirs(os.path.dirname(os.path.abspath(targetFile)),
                    exist_ok=True)
        shutil.copyfile(src, targetFile)
        return targetFile
