"""Filesystem clients (reference fleet/utils/fs.py).

Counterpart of ``paddle_tpu/distributed/fleet/utils/fs.py``, copied (it
needs neither package's arrays).  ``LocalFS`` is complete; ``HDFSClient``
builds the ``hadoop fs`` command line exactly like the reference and
runs it, so on a host without a hadoop install every call raises
``ExecuteError`` naming the missing binary (checkpoints on a mounted
path take ``LocalFS``).
"""
from __future__ import annotations

import os
import shutil
import subprocess


class ExecuteError(Exception):
    pass


class FS:
    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def touch(self, fs_path):
        raise NotImplementedError


class LocalFS(FS):
    """Reference fleet/utils/fs.py LocalFS."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for e in os.listdir(fs_path):
            (dirs if os.path.isdir(os.path.join(fs_path, e)) else files
             ).append(e)
        return dirs, files

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if os.path.isdir(fs_path):
            shutil.rmtree(fs_path)
        elif os.path.exists(fs_path):
            os.remove(fs_path)

    def mv(self, src, dst, overwrite=False):
        if not overwrite and os.path.exists(dst):
            raise ExecuteError(f"{dst} already exists")
        os.replace(src, dst)

    def touch(self, fs_path, exist_ok=True):
        if os.path.exists(fs_path):
            if not exist_ok:
                raise ExecuteError(f"{fs_path} already exists")
            return
        open(fs_path, "a").close()

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)


class HDFSClient(FS):
    """Reference HDFSClient: drives `hadoop fs` subcommands."""

    def __init__(self, hadoop_home, configs=None, time_out=5 * 60 * 1000,
                 sleep_inter=1000):
        self._base = [os.path.join(hadoop_home, "bin", "hadoop"), "fs"]
        self._configs = []
        for k, v in (configs or {}).items():
            self._configs += ["-D", f"{k}={v}"]

    def command(self, *args):
        """The command line a call runs: ``hadoop fs``, the ``-D``
        configs, then the subcommand's arguments."""
        return self._base + self._configs + list(args)

    def _run(self, *args):
        cmd = self.command(*args)
        if not os.path.exists(self._base[0]):
            raise ExecuteError(
                f"hadoop binary not found at {self._base[0]}; HDFSClient "
                f"needs a hadoop install (use LocalFS for mounted paths)")
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode != 0:
            raise ExecuteError(f"{' '.join(cmd)} failed: {p.stderr}")
        return p.stdout

    def ls_dir(self, fs_path):
        out = self._run("-ls", fs_path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, fs_path):
        try:
            self._run("-test", "-e", fs_path)
            return True
        except ExecuteError:
            return False

    def is_dir(self, fs_path):
        try:
            self._run("-test", "-d", fs_path)
            return True
        except ExecuteError:
            return False

    def is_file(self, fs_path):
        return self.is_exist(fs_path) and not self.is_dir(fs_path)

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        self._run("-rm", "-r", fs_path)

    def mv(self, src, dst, overwrite=False):
        if self.is_exist(dst):
            if not overwrite:
                raise ExecuteError(
                    f"hdfs mv: destination {dst!r} exists and "
                    f"overwrite=False")
            # hadoop fs -mv refuses to clobber; reference HDFSClient
            # deletes dst first when overwrite=True
            self.delete(dst)
        self._run("-mv", src, dst)

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def touch(self, fs_path, exist_ok=True):
        self._run("-touchz", fs_path)
