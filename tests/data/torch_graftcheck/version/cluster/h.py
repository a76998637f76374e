from http.server import BaseHTTPRequestHandler


class H(BaseHTTPRequestHandler):
    def _send(self, code, body):
        self.send_response(code)

    def do_POST(self):
        if self.path == "/worker/x":
            self._send(200, b"ok")
