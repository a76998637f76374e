from http.server import BaseHTTPRequestHandler


class _HttpHandlerBase(BaseHTTPRequestHandler):
    def _send(self, code, body, headers=None):
        self.send_response(code)
        self.send_header("X-Trace-Id", "tid")


class H(_HttpHandlerBase):
    def do_POST(self):
        self._send(429, b"overloaded")

    def naked(self):
        self.send_response(200)
