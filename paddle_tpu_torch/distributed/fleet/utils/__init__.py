"""fleet.utils: the filesystem clients (reference fleet/utils/fs.py:
``LocalFS``, ``HDFSClient``) and the HTTP KV server (reference
fleet/utils/http_server.py, the KV used by RoleMaker's gloo
rendezvous)."""
from .fs import FS, ExecuteError, HDFSClient, LocalFS  # noqa: F401
from .http_server import KVHandler, KVHTTPServer, KVServer  # noqa: F401
