"""Seeded protocol fault: a port front-door handler answers a route the
static wire contract does not know."""

import threading
import urllib.request
from http.server import ThreadingHTTPServer


def test_off_contract_route():
    from tfidf_tpu_torch.cluster.router import _HttpHandlerBase

    class Handler(_HttpHandlerBase):
        def do_GET(self):
            self._send(200, b"{}")

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/seeded/off-route"
        with urllib.request.urlopen(url, timeout=10.0) as r:
            assert r.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
