import urllib.parse
from http.server import BaseHTTPRequestHandler


class H(BaseHTTPRequestHandler):
    def do_POST(self):
        u = urllib.parse.urlparse(self.path)
        if u.path == "/worker/served":
            pass
