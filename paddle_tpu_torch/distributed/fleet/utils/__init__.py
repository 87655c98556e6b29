"""fleet.utils: the HTTP KV server (reference fleet/utils/http_server.py,
the KV used by RoleMaker's gloo rendezvous).  The filesystem clients
(``fs.py``) wait for ROADMAP Queue A item 8."""
from .http_server import KVHandler, KVHTTPServer, KVServer  # noqa: F401
