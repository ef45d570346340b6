"""Clip sets + crash recovery (reference `src/sethandler.c`,
`src/clip_load_save.c:3115-3212` recovery model).

A set = named directory under the workdir holding clip directories, an
`order` file, and `layouts/` (serialized event lists). Every opened clip is
journaled to a recovery file; on startup `check_recovery` offers the
journal back (the clip on disk *is* the checkpoint).

Counterpart of `lives_tpu/sets.py:1-151` on the port's `Clip` and
`Multitrack`: host file work, copied; the set trees, `order` files,
layouts and recovery journal are the JAX package's bytes.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import TYPE_CHECKING

from .io.clips import Clip

if TYPE_CHECKING:
    from .api import LiVESApp

RECOVERY_FILE = "recovery.lives_tpu"


def save_set(app: "LiVESApp", name: str) -> Path:
    """on_save_set_activate (sethandler.c:405): move clips under the set
    dir + write order file + layouts."""
    set_dir = app.workdir / "sets" / name
    (set_dir / "clips").mkdir(parents=True, exist_ok=True)
    order = []
    for c in app._clips:
        clip = c.raw()
        clip.save_header()
        dst = set_dir / "clips" / clip.handle
        if clip.clip_dir != dst:
            if dst.exists():
                shutil.rmtree(dst)
            shutil.copytree(clip.clip_dir, dst)
        order.append(clip.handle)
    (set_dir / "order").write_text("\n".join(order) + "\n")
    lay_dir = set_dir / "layouts"
    lay_dir.mkdir(exist_ok=True)
    if len(app.multitrack.el):
        app.multitrack.save_layout(str(lay_dir / "layout.json"))
    return set_dir


def load_set(app: "LiVESApp", name: str) -> int:
    """reload_set (sethandler.c:832). Returns number of clips loaded."""
    from .api import LiVESClip
    from .multitrack import Multitrack
    set_dir = app.workdir / "sets" / name
    order = (set_dir / "order").read_text().split()
    n = 0
    for handle in order:
        d = set_dir / "clips" / handle
        if not d.is_dir():
            continue
        clip = Clip.load(d)
        c = LiVESClip(app, clip, len(app._clips) + 1)
        app._clips.append(c)
        n += 1
    layout = set_dir / "layouts" / "layout.json"
    if layout.exists():
        app.multitrack = Multitrack.load_layout(str(layout))
    app.set.name = name
    return n


def list_sets(workdir: Path) -> list[str]:
    d = Path(workdir) / "sets"
    return sorted(p.name for p in d.iterdir() if p.is_dir()) \
        if d.is_dir() else []


# ---------------------------------------------------------------------------
# Crash recovery journal
# ---------------------------------------------------------------------------

def add_to_recovery(workdir: Path, clip_dir: Path):
    """add_to_recovery_file (clip_load_save.c:3115)."""
    f = Path(workdir) / RECOVERY_FILE
    with open(f, "a") as fh:
        fh.write(str(clip_dir) + "\n")


def rewrite_recovery(workdir: Path, clip_dirs: list[Path]):
    (Path(workdir) / RECOVERY_FILE).write_text(
        "".join(str(d) + "\n" for d in clip_dirs))


def check_recovery(workdir: Path) -> list[Path]:
    """check_for_recovery_files (clip_load_save.c:3212): surviving clip
    dirs from a previous crashed session."""
    f = Path(workdir) / RECOVERY_FILE
    if not f.exists():
        return []
    out = []
    for line in f.read_text().splitlines():
        d = Path(line.strip())
        if d.is_dir() and (d / "header.lives").exists():
            out.append(d)
    return out


def recover_clips(app: "LiVESApp") -> int:
    """recover_files (clip_load_save.c:2654)."""
    from .api import LiVESClip
    n = 0
    for d in check_recovery(app.workdir):
        try:
            clip = Clip.load(d)
        except Exception:
            continue
        if not clip.check_integrity():
            continue
        c = LiVESClip(app, clip, len(app._clips) + 1)
        app._clips.append(c)
        n += 1
    return n


def clear_recovery(workdir: Path):
    f = Path(workdir) / RECOVERY_FILE
    if f.exists():
        f.unlink()


# ---------------------------------------------------------------------------
# Whole-clip backup / restore (reference backup_file/restore_file .lv1,
# clip_load_save.c:1608,1774)
# ---------------------------------------------------------------------------

def backup_clip(clip, path: str | Path):
    """Pack a clip directory into a single .lvt archive (tar.gz)."""
    import tarfile
    clip.save_header()
    with tarfile.open(path, "w:gz") as tf:
        tf.add(clip.clip_dir, arcname=clip.clip_dir.name)
    return Path(path)


def restore_clip(path: str | Path, workdir: str | Path):
    """Unpack a .lvt archive into workdir; returns the loaded Clip."""
    import tarfile
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with tarfile.open(path, "r:gz") as tf:
        names = tf.getnames()
        root = names[0].split("/")[0]
        tf.extractall(workdir, filter="data")
    return Clip.load(workdir / root)
