import urllib.parse
from http.server import BaseHTTPRequestHandler


class H(BaseHTTPRequestHandler):
    def do_GET(self):
        u = urllib.parse.urlparse(self.path)
        if u.path == "/api/nobody-calls-me":
            pass
