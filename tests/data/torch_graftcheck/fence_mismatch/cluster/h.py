from http.server import BaseHTTPRequestHandler


class H(BaseHTTPRequestHandler):
    def do_POST(self):
        self._send(200, b"ok")

    def _send(self, code, body):
        self.send_response(code)
